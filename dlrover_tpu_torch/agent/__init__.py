"""The agent-side checkpoint saver: the port of ``dlrover_tpu/agent``."""
