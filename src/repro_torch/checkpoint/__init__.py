"""Msgpack checkpoints of pytrees and FL runs, byte-compatible with the
reference's (`repro.checkpoint`), written without the msgpack package."""

from repro_torch.checkpoint.ckpt import (CheckpointManager, FLCheckpoint,
                                         latest_step, load_fl_checkpoint,
                                         restore_pytree, save_fl_checkpoint,
                                         save_pytree)

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "CheckpointManager", "FLCheckpoint", "save_fl_checkpoint",
           "load_fl_checkpoint"]
