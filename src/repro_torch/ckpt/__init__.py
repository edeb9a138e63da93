"""Checkpointing: save/restore in the reference's on-disk format, the async
keep-N ``Checkpointer``, and the pure checkpoint cost model."""
from repro_torch.ckpt.checkpoint import (Checkpointer, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.ckpt.cost import CheckpointCostModel

__all__ = ["CheckpointCostModel", "Checkpointer", "save_checkpoint",
           "restore_checkpoint", "latest_step"]
