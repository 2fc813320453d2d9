"""Optimizer recipe and the training harness."""
