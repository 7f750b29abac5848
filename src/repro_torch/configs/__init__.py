"""Config registry: one module per assigned architecture (the port's copy of
the reference's ten, with the same published numbers and `source` tags)."""
from .base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, get_config, list_configs, register

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        qwen3_0_6b,
        minitron_4b,
        phi4_mini_3_8b,
        qwen2_1_5b,
        phi3_5_moe,
        grok1_314b,
        mamba2_370m,
        whisper_large_v3,
        llama32_vision_11b,
        jamba_v0_1,
    )

    _LOADED = True
