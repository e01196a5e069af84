"""Async, *verified* checkpointing (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (CheckpointCorruptionError,
                                            CheckpointManager)

__all__ = ["manager", "CheckpointCorruptionError", "CheckpointManager"]
