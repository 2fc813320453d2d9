"""Data-parallel gradient sync: the port of ``dlrover_tpu/parallel``."""
