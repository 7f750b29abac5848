"""Architecture config system: the port's own copy of the reference's.

One `ModelConfig` per assigned architecture (exact published numbers) plus a
`reduced()` shrink used by CPU smoke tests.  `layer_kinds()` derives the
per-layer (mixer, ffn) pattern, which repeats with `period`; the port walks
the layers in depth order (layer i is position i % period of repeat
i // period).  `remat` and `remat_group` choose what the training path
recomputes in its backward pass (`torch.utils.checkpoint`); `scan_unroll`
and `barrier_xs` shape the reference's XLA graph only: the port accepts
them and they have no effect.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "ShapeConfig", "register", "get_config", "list_configs", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    dispatch: str = "remap"  # 'remap' (paper Approach 1) | 'onehot' (Approach 2 baseline)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    norm: str = "rms"  # 'rms' | 'ln' (whisper)
    act: str = "silu"  # 'silu' -> SwiGLU (3 mats), 'gelu' -> classic 2-mat MLP
    moe: MoEConfig | None = None
    moe_stride: int = 1  # MoE at layers where (idx % stride == offset)
    moe_offset: int = 0
    ssm: SSMConfig | None = None
    attn_stride: int = 0  # hybrid: attention at layers where idx % stride == offset
    attn_offset: int = 0
    # enc-dec (audio family)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30 s @ 50 Hz after conv stub
    # vlm
    xattn_stride: int = 0  # cross-attn at layers where idx % stride == offset
    xattn_offset: int = 0
    img_tokens: int = 0
    # numerics / distribution hints
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False  # shard params over the data axis too (ZeRO-3 analogue)
    remat: bool = True
    remat_group: int = 0  # >1: two-level (sqrt) remat — outer scan saves only
    # n_reps/remat_group boundary activations; inner layers recompute within
    # the group on backward (Chen et al. 2016 sqrt-schedule)
    scan_unroll: bool = False  # unroll layer loop (roofline cost probes only)
    barrier_xs: bool = False  # tie each layer's param slice to the running
    # carry via optimization_barrier: defeats XLA's slice-of-all-gather
    # hoisting, which otherwise keeps a fully-gathered copy of the whole
    # (bf16) parameter stack live across the loop (memory <-> overlap trade)
    source: str = ""  # provenance tag from the assignment table

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a 256 multiple so the vocab dim always
        shards over TP (whisper's 51866 / mamba2's 50280 otherwise fall back
        to d_model-sharded tables, which trips an XLA SPMD dynamic-slice bug
        and shards worse).  Pad logits are masked to -inf in lm_logits."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def period(self) -> int:
        """Smallest repeating layer-pattern period (scan unit)."""
        p = 1
        for s in (self.moe_stride if self.moe else 1, self.attn_stride or 1, self.xattn_stride or 1):
            p = math.lcm(p, max(s, 1))
        return p

    def layer_kinds(self) -> list[tuple[str, str]]:
        """(mixer, ffn) per layer. mixer: attn|mamba|xattn; ffn: mlp|moe|none."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.attn_stride:
                mixer = "attn" if i % self.attn_stride == self.attn_offset else "mamba"
            elif self.xattn_stride:
                mixer = "xattn" if i % self.xattn_stride == self.xattn_offset else "attn"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"  # mamba2 blocks carry no separate FFN
            elif self.moe and i % self.moe_stride == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mixer, ffn))
        return kinds

    def pattern_kinds(self) -> list[tuple[str, str]]:
        """One period of layer kinds (repeated n_layers/period times)."""
        kinds = self.layer_kinds()
        p = self.period
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        assert kinds[:p] * (self.n_layers // p) == kinds, "pattern not periodic"
        return kinds[:p]

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        for mixer, ffn in self.layer_kinds():
            if mixer == "attn" or mixer == "xattn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                if mixer == "xattn":  # extra kv proj for image stream shares the count above
                    pass
            elif mixer == "mamba":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
                total += conv_dim * s.d_conv + d_in * d  # conv + out_proj
            if ffn == "mlp":
                nmat = 3 if self.act in ("silu", "gelu_glu") else 2
                total += nmat * d * self.d_ff
            elif ffn == "moe":
                m = self.moe
                nmat = 3 if self.act in ("silu", "gelu_glu") else 2
                total += m.num_experts * nmat * d * m.d_ff + d * m.num_experts
            total += 2 * d  # norms
        if self.encoder_layers:
            per = 4 * d * hd * self.n_heads / self.hd  # enc attn  (approx: full heads)
            total += int(self.encoder_layers * (4 * d * d + 2 * d * self.d_ff + 2 * d))
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        nmat = 3 if self.act in ("silu", "gelu_glu") else 2
        moe_layers = sum(1 for _, f in self.layer_kinds() if f == "moe")
        dense_equiv = self.param_count() - moe_layers * m.num_experts * nmat * self.d_model * m.d_ff
        return int(dense_equiv + moe_layers * m.top_k * nmat * self.d_model * m.d_ff)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke-test shrink: same family/pattern, tiny dims."""
        p = self.period
        changes = dict(
            n_layers=2 * p,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
            vocab=256,
            head_dim=16,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else 1500,
            img_tokens=8 if self.img_tokens else 0,
            fsdp=False,
            remat=False,
            compute_dtype="float32",
        )
        if self.moe:
            # capacity_factor = num_experts makes drops impossible, so smoke
            # tests can assert exact prefill/decode and remap/onehot equality.
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff=96, capacity_factor=4.0
            )
        if self.ssm:
            changes["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=8)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # noqa — populate registry

    _load_all()
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
