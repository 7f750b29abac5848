"""whisper-large-v3 [audio] — 32L d_model=1280 20H (kv=20, full MHA)
d_ff=5120 vocab=51866. Enc-dec; conv frontend is a STUB: input_specs()
supplies precomputed 1500-frame embeddings. [arXiv:2212.04356; unverified]

Adaptation note (DESIGN.md §5): learned positional embeddings are replaced by
sinusoidal so the assigned 4k/32k decoder lengths are representable."""
from .base import ModelConfig, register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,  # decoder layers; encoder_layers below
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51_866,
        head_dim=64,
        act="gelu",
        norm="ln",
        rope_theta=0.0,  # sinusoid positions (adaptation: learned -> sinusoid)
        tie_embeddings=True,
        norm_eps=1e-5,
        encoder_layers=32,
        encoder_seq=1500,
        source="arXiv:2212.04356; unverified",
    )
