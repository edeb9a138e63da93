"""Checkpoint restore (the save half comes with training)."""
from repro_torch.ckpt.checkpoint import latest_step, restore_checkpoint
