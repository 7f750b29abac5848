"""Training substrate of the port: the checkpoint manager (the planned drive
loop's checkpoint/resume rides on it too) and the LM stack's AdamW, stacked
trees and train step (`optimizer`, `stacks`, `train_step`; import them
from their modules)."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
