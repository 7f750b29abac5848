"""mamba2-370m [ssm] — 48L d_model=1024 (attn-free) d_ff=0 vocab=50280,
ssm_state=128. SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50_280,
        tie_embeddings=True,
        norm_eps=1e-5,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
        source="arXiv:2405.21060; unverified",
    )
