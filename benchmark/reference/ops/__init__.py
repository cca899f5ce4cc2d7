# Frozen copy of nhwcodec_tpu_torch/host/ops/__init__.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
