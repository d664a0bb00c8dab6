"""Atomic, restart-safe checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore, restore_ocf,
                                         restore_sharded, save, save_sharded)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "restore_ocf",
           "restore_sharded", "save", "save_sharded"]
