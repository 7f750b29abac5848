"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2. Mamba:attn 7:1 interleave (attention at
layer index 4 of each 8), MoE every other layer. [arXiv:2403.19887; hf]

Adaptation note: Mamba blocks are implemented as Mamba2/SSD (the repo's SSM
substrate); Jamba v0.1 ships Mamba1 — state size kept at Jamba's 16."""
from .base import ModelConfig, MoEConfig, SSMConfig, register


@register("jamba-v0.1-52b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab=65_536,
        head_dim=128,
        rope_theta=10_000.0,  # jamba attn layers use no rope in v0.1; kept for cache sizing
        act="silu",
        norm_eps=1e-6,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=14_336, dispatch="remap"),
        moe_stride=2,
        moe_offset=1,
        attn_stride=8,
        attn_offset=4,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
        fsdp=True,
        source="arXiv:2403.19887; hf",
    )
