"""PyTorch/CUDA port of dlrover_tpu's compute path, for NVIDIA Hopper.

The layout mirrors ``dlrover_tpu``: ``ops/`` (attention, with the
hand-written CUDA kernels under ``ops/cuda`` and their sources in
``csrc/``), ``models/``, ``trainer/`` and ``utils/``.  The package imports
torch and numpy only; it never imports JAX or ``dlrover_tpu``.
"""
