"""Flash checkpoint: the port of ``dlrover_tpu/trainer/flash_checkpoint``
(see ``engine.py`` for what is not ported yet)."""

from dlrover_tpu_torch.trainer.flash_checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    StorageType,
)
