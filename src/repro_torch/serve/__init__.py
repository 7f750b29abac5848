"""Serving substrate: cache specs + batched prefill/decode step builders."""
from .engine import cache_pspecs, cache_specs, generate, make_decode_step, make_prefill_step

__all__ = ["cache_pspecs", "cache_specs", "generate", "make_decode_step", "make_prefill_step"]
