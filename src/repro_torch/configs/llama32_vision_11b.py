"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. Cross-attn image layers every 5th layer (8 of 40); vision tower
is a STUB: input_specs() supplies precomputed, projected patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig, register


@register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab=128_256,
        head_dim=128,
        rope_theta=500_000.0,
        act="silu",
        norm_eps=1e-5,
        xattn_stride=5,
        xattn_offset=3,  # layers 3, 8, ..., 38
        img_tokens=1601,  # one 448px tile -> 1601 patch tokens (projected)
        fsdp=True,
        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
    )
