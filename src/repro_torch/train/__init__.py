"""Training substrate of the port: the checkpoint manager (the planned drive
loop's checkpoint/resume rides on it too) and the LM stack's AdamW and
train step.  The LM names resolve on first use, so that a checkpoint of a
decomposition does not load the LM stack."""
from .._lazy import lazy_attrs
from .checkpoint import CheckpointManager

_EXPORTS = {
    ".optimizer": ("AdamWConfig", "adamw_init", "adamw_update"),
    ".train_step": ("TrainState", "make_train_step", "init_train_state"),
}

__all__ = [name for names in _EXPORTS.values() for name in names] + ["CheckpointManager"]
__getattr__ = lazy_attrs(__name__, {name: mod for mod, names in _EXPORTS.items() for name in names})
