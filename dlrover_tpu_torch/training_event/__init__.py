"""Training-event emitter: the port of ``dlrover_tpu/training_event``."""
