"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf] (head_dim=128 per the Qwen3 family)."""
from .base import ModelConfig, register


@register("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab=151_936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        act="silu",
        norm_eps=1e-6,
        fsdp=False,
        source="hf:Qwen/Qwen3-8B; hf",
    )
