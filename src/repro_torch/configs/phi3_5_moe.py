"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]

MoE dispatch uses the paper's Approach-1 remap (DESIGN.md §5)."""
from .base import ModelConfig, MoEConfig, register


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab=32_064,
        head_dim=128,
        rope_theta=10_000.0,
        act="silu",
        norm_eps=1e-5,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400, dispatch="remap"),
        fsdp=True,
        source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
    )
