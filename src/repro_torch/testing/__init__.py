"""Test-support utilities shipped with the package: the fault-injection
harness `repro_torch.testing.faults` shows that every guard of the
resilience layer fires and every policy recovers."""
from . import faults  # noqa: F401

__all__ = ["faults"]
