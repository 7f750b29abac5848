"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig, MoEConfig, register


@register("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32_768,
        vocab=131_072,
        head_dim=128,
        rope_theta=10_000.0,
        act="gelu_glu",  # grok-1: gated GeGLU experts (3 matrices -> 314B total)
        norm_eps=1e-5,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32_768, dispatch="remap"),
        fsdp=True,
        source="hf:xai-org/grok-1; unverified",
    )
