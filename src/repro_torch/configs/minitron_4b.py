"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000. Pruned nemotron (squared-ReLU MLP). [arXiv:2407.14679; hf]"""
from .base import ModelConfig, register


@register("minitron-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256_000,
        head_dim=128,
        rope_theta=10_000.0,
        act="relu2",  # nemotron-family squared-ReLU, 2-matrix MLP
        norm_eps=1e-5,
        fsdp=True,
        source="arXiv:2407.14679; hf",
    )
