"""What the port copies from ``dlrover_tpu/common``."""
