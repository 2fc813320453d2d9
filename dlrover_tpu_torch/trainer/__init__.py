"""Optimizer recipe, the training harness, flash checkpoint, the worker
bootstrap and the launcher (``elastic_run``)."""
