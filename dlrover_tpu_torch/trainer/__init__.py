"""Optimizer recipe, the training harness, flash checkpoint, the elastic
input pipeline, the worker bootstrap and the launcher (``elastic_run``)."""
