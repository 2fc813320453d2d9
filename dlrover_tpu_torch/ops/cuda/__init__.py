"""Hand-written CUDA kernels (sources in dlrover_tpu_torch/csrc)."""
