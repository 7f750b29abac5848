"""Data pipeline: the deterministic synthetic token stream with prefetch
(the port's copy of `repro.data`)."""
from .pipeline import TokenPipeline, make_batch_iterator

__all__ = ["TokenPipeline", "make_batch_iterator"]
