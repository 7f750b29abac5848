"""Training substrate of the port.  Only the checkpoint manager so far: the
planned drive loop's checkpoint/resume rides on it.  The optimizer and the
train step come with the LM stack."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
