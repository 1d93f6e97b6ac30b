"""Hand-written CUDA kernels (sources in ``rumpy_tpu_torch/csrc``)."""
