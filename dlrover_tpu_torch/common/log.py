"""Logging setup (env-tunable level, one formatter everywhere).

Copy of ``dlrover_tpu/common/log.py``: the logger of the modules the port
copies from the reference (flash checkpoint and what it pulls in).  It is
named after this module, so the port's other module loggers
(``logging.getLogger(__name__)``) are not its children and keep
propagating to the root.
"""

import logging
import sys

from dlrover_tpu_torch.common import envs

_LOG_LEVEL_ENV = "DLROVER_TPU_LOG_LEVEL"
_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger(name: str = __name__) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    level_name = envs.get_str(_LOG_LEVEL_ENV).upper()
    level = getattr(logging, level_name, logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


default_logger = _build_logger()
logger = default_logger
