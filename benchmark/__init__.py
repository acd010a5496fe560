"""The benchmark of supersampler_tpu_torch, the PyTorch and CUDA port:
one cell of BENCHMARK.json a run (``python -m benchmark.run``)."""
