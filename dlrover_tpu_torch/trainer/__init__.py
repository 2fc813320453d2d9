"""Optimizer recipe, the training harness and flash checkpoint."""
