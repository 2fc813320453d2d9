"""The ``DLROVER_TPU_*`` environment knobs that the port reads.

A copy of the grad-sync knobs of ``dlrover_tpu/common/envs.py``: the same
names, defaults and parsing.  Values are read from ``os.environ`` at call
time; a malformed value logs a warning and falls back to the default.
"""

import logging
import os

logger = logging.getLogger(__name__)

DEFAULTS = {
    # MB of fp32 gradient per grad-sync bucket; 0 = per-leaf collectives.
    # GradSyncPolicy(bucket_mb=...) overrides per trainer
    "DLROVER_TPU_GRAD_BUCKET_MB": 4.0,
    # reduce-scatter transport: auto | all_to_all | ring | ring_pallas |
    # ring_rdma | ring_pallas_q; each tier falls back when its
    # preconditions fail
    "DLROVER_TPU_GRAD_TRANSPORT": "auto",
    # blockwise mode: fraction of blocks per chunk that ship an int8
    # refinement over the int4 base
    "DLROVER_TPU_GRAD_HI_FRAC": 0.125,
    # the one-kernel RDMA ring for transport=ring_rdma
    "DLROVER_TPU_GRAD_RING_RDMA": False,
}

_TRUE_WORDS = ("1", "true", "yes", "on")
_FALSE_WORDS = ("0", "false", "no", "off", "")


def _complain(name: str, value: str, type_: str, fallback) -> None:
    logger.warning("env %s=%r is not a valid %s; using %r", name, value,
                   type_, fallback)


def get_str(name: str) -> str:
    return os.environ.get(name, DEFAULTS[name])


def get_float(name: str) -> float:
    fallback = DEFAULTS[name]
    value = os.environ.get(name)
    if value is None:
        return fallback
    try:
        return float(value)
    except ValueError:
        _complain(name, value, "float", fallback)
        return fallback


def get_bool(name: str) -> bool:
    fallback = DEFAULTS[name]
    value = os.environ.get(name)
    if value is None:
        return fallback
    word = value.strip().lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    _complain(name, value, "bool", fallback)
    return fallback
