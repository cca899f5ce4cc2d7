"""The benchmark of the PyTorch/CUDA port ``nhwcodec_tpu_torch``.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md says
how cells, configurations, traffic mixes and metric readers are added as
files.
"""
