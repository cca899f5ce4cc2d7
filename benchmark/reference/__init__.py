"""The benchmark's plain reference: the codec's host encoder and decoder.

A frozen copy of ``nhwcodec_tpu_torch/host`` at commit a4a43cf: the
tables, the .nhw container, the host encoder's scans and tokenizer, the
entropy and DC-plane decoders, the host decoder and their C scans
(``native/hotpass.c``, built with cffi on first use into
``native/_build/`` inside the checkout).  The module paths are rewritten
to ``benchmark.reference``, and the C build's switches are cut
(``native/__init__.py``); nothing else changed.  The host batch services
(``parallel``) and the fixtures are not copied.  It imports neither torch
nor anything of ``nhwcodec_tpu_torch``, so later changes to the program
cannot move the yardstick.  The C scans are built by one fixed recipe,
which no environment variable changes; where their build fails, the
pure-Python path gives the same bytes, 70 times slower.
"""
