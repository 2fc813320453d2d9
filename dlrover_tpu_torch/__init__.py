"""PyTorch/CUDA port of dlrover_tpu, for NVIDIA Hopper.

The layout mirrors ``dlrover_tpu``: ``ops/`` (attention, with the
hand-written CUDA kernels under ``ops/cuda`` and their sources in
``csrc/``), ``models/``, ``parallel/``, ``trainer/`` (the launcher
``trainer/elastic_run.py`` among them), the job runtime's ``master/``,
``agent/`` and ``diagnosis/``, ``observability/``, ``common/``, ``utils/``
and ``examples/``.  The package imports torch and numpy only; it never
imports JAX or ``dlrover_tpu``.
"""
