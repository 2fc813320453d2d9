"""The per-host elastic agent, its master client and config tuner, and the
checkpoint saver it owns: the port of ``dlrover_tpu/agent``."""
