"""The LM stack's layers in the port against the JAX package's on the CPU,
float32, the same numpy inputs on both sides: norms, RoPE and sinusoids,
MLPs, attention (causal by chunks, decode with the future masked, cross),
the MoE router (ties included), both dispatch modes (the same assignments
drop, bit for bit) and the layer, and the SSD/Mamba2 paths."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as RA, layers as RL, moe as RM, ssm as RS
from repro_torch.configs import MoEConfig, get_config
from repro_torch.models import attention as A, layers as L, moe as M, ssm as S
from repro_torch.models.layers import Params
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Every output within TOL of the largest |value| of the reference's output.
TOL = 1e-5


def rel_err(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def to_params(tree: dict) -> Params:
    """A reference parameter dict (numpy leaves) as the port's Params."""
    return Params(**{k: to_params(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
                     for k, v in tree.items()})


def both(tree: dict):
    """(jax dict, port Params) of a reference parameter dict."""
    npt = jax.tree.map(np.asarray, tree)
    return jax.tree.map(jnp.asarray, npt), to_params(npt)


def t(a):
    return torch.tensor(a)


def j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# norms, RoPE, sinusoids, MLPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = randn(rng, 3, 5, 32)
    p = {"scale": randn(rng, 32), "bias": randn(rng, 32)} if kind == "ln" else {"scale": randn(rng, 32)}
    want = RL.norm_apply(kind, jax.tree.map(j, p), j(x), 1e-5)
    got = L.norm_apply(kind, to_params(p), t(x), 1e-5)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 12, 4, 16)
    pos = np.arange(12)
    cw, sw = RL.rope_angles(j(pos), 16, theta)
    cg, sg = L.rope_angles(t(pos), 16, theta)
    assert rel_err(cg, cw) <= TOL and rel_err(sg, sw) <= TOL
    assert rel_err(L.apply_rope(t(x), cg, sg), RL.apply_rope(j(x), cw, sw)) <= TOL
    # decode-side angles: per-batch positions (B, 1)
    bpos = np.array([[7], [300]])
    cw, sw = RL.rope_angles(j(bpos), 16, theta)
    cg, sg = L.rope_angles(t(bpos), 16, theta)
    assert rel_err(L.apply_rope(t(x[:, :1]), cg, sg), RL.apply_rope(j(x[:, :1]), cw, sw)) <= TOL


def test_sinusoids():
    want = np.asarray(RL.sinusoid_positions(40, 64))
    np.testing.assert_array_equal(L.sinusoid_positions(40, 64).numpy(), want)
    table = np.asarray(RL.sinusoid_positions(1 << 16, 64))
    pos = np.array([0, 1, 39, 4_097, 65_535])
    assert rel_err(L.sinusoid_rows(t(pos), 64), table[pos]) <= 1e-7


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_glu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    pj, pt = both(RL.mlp_init(jax.random.PRNGKey(0), 32, 48, act))
    if "bu" in pt:  # non-zero biases
        pj = dict(pj, bu=j(randn(rng, 48)), bd=j(randn(rng, 32)))
        pt = to_params(jax.tree.map(np.asarray, pj))
    x = randn(rng, 2, 7, 32)
    assert rel_err(L.mlp(pt, t(x), act), RL.mlp(pj, j(x), act)) <= TOL


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(L.gelu(t(x)).numpy(), np.asarray(jax.nn.gelu(j(x))), rtol=0, atol=1e-6)
    assert float((L.gelu(t(x)) - torch.nn.functional.gelu(t(x))).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2), (6, 1)], ids=lambda h: f"H{h[0]}-KV{h[1]}")
def test_causal_attention(chunk, heads):
    H, KVH = heads
    rng = np.random.default_rng(3)
    q, k, v = randn(rng, 2, 16, H, 8), randn(rng, 2, 16, KVH, 8), randn(rng, 2, 16, KVH, 8)
    want = jax.jit(RA.causal_attention, static_argnames="chunk")(j(q), j(k), j(v), chunk=chunk)
    got = A.causal_attention(t(q), t(k), t(v), chunk=chunk)
    assert rel_err(got, want) <= TOL
    with pytest.raises(ValueError, match="multiple"):
        A.causal_attention(t(q[:, :15]), t(k[:, :15]), t(v[:, :15]), chunk=4)


def test_decode_attention_masks_the_future():
    rng = np.random.default_rng(4)
    q, kc, vc = randn(rng, 3, 1, 8, 8), randn(rng, 3, 20, 2, 8), randn(rng, 3, 20, 2, 8)
    pos = np.array([0, 7, 19])
    want = RA.decode_attention(j(q), j(kc), j(vc), j(pos))
    got = A.decode_attention(t(q), t(kc), t(vc), t(pos))
    assert rel_err(got, want) <= TOL
    # rows past pos are never read: huge values there change nothing
    kf, vf = kc.copy(), vc.copy()
    for b, p in enumerate(pos):
        kf[b, p + 1:] = 1e6
        vf[b, p + 1:] = -1e6
    assert torch.equal(A.decode_attention(t(q), t(kf), t(vf), t(pos)), got)


def test_self_attention_prefill_and_decode_write():
    """qk-norm and qkv-bias; the decode step's indexed cache write equals the
    reference's one-hot blend."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), qkv_bias=True)
    rng = np.random.default_rng(5)
    tree = RA.attn_init(jax.random.PRNGKey(1), 64, 4, 2, 16, qkv_bias=True, qk_norm=True)
    tree = dict(tree, bq=j(randn(rng, 64)), bk=j(randn(rng, 32)), bv=j(randn(rng, 32)),
                q_norm={"scale": j(randn(rng, 16))})
    pj, pt = both(tree)
    x = randn(rng, 2, 8, 64)
    yw, kvw = jax.jit(lambda p, x: RA.self_attention_prefill(p, x, cfg, chunk=4))(pj, j(x))
    yg, kvg = A.self_attention_prefill(pt, t(x), cfg, chunk=4)
    assert rel_err(yg, yw) <= TOL and rel_err(kvg["k"], kvw["k"]) <= TOL and rel_err(kvg["v"], kvw["v"]) <= TOL
    cache = {"k": randn(rng, 2, 12, 2, 16), "v": randn(rng, 2, 12, 2, 16)}
    x1, pos = randn(rng, 2, 1, 64), np.array([3, 11])
    yw, cw = RA.self_attention_decode(pj, j(x1), jax.tree.map(j, cache), j(pos), cfg)
    yg, cg = A.self_attention_decode(pt, t(x1), {k: t(v) for k, v in cache.items()}, t(pos), cfg)
    assert rel_err(yg, yw) <= TOL
    for name in ("k", "v"):
        assert rel_err(cg[name], cw[name]) <= TOL
        keep = np.ones((2, 12), bool)
        keep[[0, 1], pos] = False
        np.testing.assert_array_equal(cg[name].numpy()[keep], cache[name][keep])


def test_cross_attention():
    cfg = get_config("llama-3.2-vision-11b").reduced()
    rng = np.random.default_rng(6)
    pj, pt = both(RA.xattn_init(jax.random.PRNGKey(2), 64, 4, 2, 16))
    x, mem = randn(rng, 2, 5, 64), randn(rng, 2, 9, 64)
    yw, kvw = RA.cross_attention(pj, j(x), j(mem), cfg)
    yg, kvg = A.cross_attention(pt, t(x), t(mem), cfg)
    assert rel_err(yg, yw) <= TOL and rel_err(kvg["k"], kvw["k"]) <= TOL
    y2, _ = A.cross_attention(pt, t(x), None, cfg, kvg)
    assert torch.equal(y2, yg)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_setup(cf: float, seed: int = 7, E: int = 4, k: int = 2, G: int = 2, Tg: int = 24):
    cfg = MoEConfig(num_experts=E, top_k=k, d_ff=24, capacity_factor=cf)
    tree = jax.tree.map(np.array, RM.moe_init(jax.random.PRNGKey(seed), 32, cfg, "silu"))
    x = randn(np.random.default_rng(seed), G, Tg, 32)
    return cfg, tree, x


def test_router_topk_with_a_tie():
    cfg, tree, x = moe_setup(1.0)
    tree["router"][:, 3] = tree["router"][:, 1]  # experts 1 and 3 tie on every token
    tree["router"][:, 0] *= 0.01  # ...and are often the top two
    ids_w, w_w, p_w, aux_w = RM.router_topk(jax.tree.map(j, tree), j(x), cfg)
    ids_g, w_g, p_g, aux_g = M.router_topk(to_params(tree), t(x), cfg)
    np.testing.assert_array_equal(ids_g.numpy(), np.asarray(ids_w))
    tie = np.asarray(p_w)[..., 1] == np.asarray(p_w)[..., 3]
    assert tie.all() and (np.asarray(ids_w)[..., 0] == 1).any()  # the tie is met, lower id first
    assert rel_err(w_g, w_w) <= TOL and rel_err(p_g, p_w) <= TOL
    for key in ("load_balance", "router_z"):
        assert rel_err(aux_g[key], aux_w[key]) <= TOL


@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
def test_dispatch_modes(cf):
    cfg, tree, x = moe_setup(cf)
    E, Tg = cfg.num_experts, x.shape[1]
    C = M.capacity(Tg, cfg)
    assert C == RM.capacity(Tg, cfg)
    ids, w, _, _ = M.router_topk(to_params(tree), t(x), cfg)
    buf, meta = M.dispatch_remap(t(x), ids, E, C)
    disp, comb = M.dispatch_onehot(t(x), ids, w, E, C)
    _, keep_onehot = M.onehot_slots(ids, E, C)
    for g in range(x.shape[0]):  # the reference dispatches one group
        bw, mw = RM.dispatch_remap(j(x[g]), j(ids[g].numpy().astype(np.int32)), E, C)
        for key in ("dest", "tok_sorted", "perm", "keep"):
            np.testing.assert_array_equal(meta[key][g].numpy(), np.asarray(mw[key]), err_msg=key)
        np.testing.assert_array_equal(buf[g].numpy(), np.asarray(bw))
        dw, cw = RM.dispatch_onehot(j(x[g]), j(ids[g].numpy().astype(np.int32)), j(w[g].numpy()), E, C)
        np.testing.assert_array_equal(disp[g].numpy(), np.asarray(dw))
        assert rel_err(comb[g], cw) <= TOL
        out_e = np.asarray(RM.experts_ffn(jax.tree.map(j, tree), bw, "silu"))
        cw_out = RM.combine_remap(j(out_e), mw, j(w[g].numpy().reshape(-1)), Tg)
        cg_out = M.combine_remap(t(out_e)[None], {k: v[g:g + 1] for k, v in meta.items()},
                                 w[g:g + 1].reshape(1, -1), Tg)[0]
        assert rel_err(cg_out, cw_out) <= TOL
    # the two modes drop the same assignments: remap's keep back in
    # assignment order is onehot's
    unsorted = torch.empty_like(meta["keep"]).scatter_(-1, meta["perm"], meta["keep"])
    assert torch.equal(unsorted, keep_onehot)
    dropped = int((~keep_onehot).sum())
    if cf == 4.0:
        assert dropped == 0
    if cf == 0.5:
        assert dropped > 0


@pytest.mark.parametrize("dispatch", ["remap", "onehot"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_apply(dispatch, cf):
    cfg, tree, x = moe_setup(cf)
    cfg = dataclasses.replace(cfg, dispatch=dispatch)
    ow, auxw = RM.moe_apply(jax.tree.map(j, tree), j(x), cfg, "silu")
    og, auxg = M.moe_apply(to_params(tree), t(x), cfg, "silu")
    assert rel_err(og, ow) <= TOL
    assert rel_err(auxg["load_balance"], auxw["load_balance"]) <= TOL


def test_moe_modes_agree():
    cfg, tree, x = moe_setup(0.5)
    out = {d: M.moe_apply(to_params(tree), t(x), dataclasses.replace(cfg, dispatch=d), "gelu_glu")[0]
           for d in ("remap", "onehot")}
    assert rel_err(out["remap"], out["onehot"].numpy()) <= TOL


# ---------------------------------------------------------------------------
# SSD / Mamba2
# ---------------------------------------------------------------------------


def ssd_inputs(S_len: int, seed: int = 8, B=2, H=4, P=8, G=2, N=6):
    rng = np.random.default_rng(seed)
    x = randn(rng, B, S_len, H, P)
    dt = np.log1p(np.exp(randn(rng, B, S_len, H))).astype(np.float32)
    A_ = -np.exp(randn(rng, H, scale=0.5)).astype(np.float32)
    Bm, Cm = randn(rng, B, S_len, G, N), randn(rng, B, S_len, G, N)
    D = randn(rng, H)
    h0 = randn(rng, B, H, P, N, scale=0.5)
    return x, dt, A_, Bm, Cm, D, h0


@functools.lru_cache
def ssd_oracle(S_len: int):
    """The reference's ssd_reference on ssd_inputs(S_len), and the port's."""
    args = ssd_inputs(S_len)
    return jax.jit(RS.ssd_reference)(*map(j, args)), S.ssd_reference(*map(t, args))


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("S_len", [16, 13], ids=["even", "ragged"])
def test_ssd_chunked(chunk, S_len):
    args = ssd_inputs(S_len)
    (yw, hw), (yr, hr) = ssd_oracle(S_len)
    assert rel_err(yr, yw) <= TOL and rel_err(hr, hw) <= TOL
    yg, hg = S.ssd_chunked(*map(t, args), chunk=chunk)
    assert rel_err(yg, yw) <= TOL and rel_err(hg, hw) <= TOL
    yc, hc = jax.jit(RS.ssd_chunked, static_argnames="chunk")(*map(j, args), chunk=chunk)
    assert rel_err(yg, yc) <= TOL and rel_err(hg, hc) <= TOL


def test_ssd_decode_chain():
    x, dt, A_, Bm, Cm, D, h0 = ssd_inputs(9)
    hw, hg = j(h0), t(h0)
    for s in range(9):
        yw, hw = RS.ssd_decode_step(hw, j(x[:, s]), j(dt[:, s]), j(A_), j(Bm[:, s]), j(Cm[:, s]), j(D))
        yg, hg = S.ssd_decode_step(hg, t(x[:, s]), t(dt[:, s]), t(A_), t(Bm[:, s]), t(Cm[:, s]), t(D))
        assert rel_err(yg, yw) <= TOL
    assert rel_err(hg, hw) <= TOL
    _, h_full = S.ssd_reference(*map(t, (x, dt, A_, Bm, Cm, D, h0)))
    assert rel_err(hg, h_full.numpy()) <= TOL


def test_causal_conv1d_and_decode_step():
    rng = np.random.default_rng(9)
    x, w, b, st = randn(rng, 2, 7, 10), randn(rng, 4, 10), randn(rng, 10), randn(rng, 2, 3, 10)
    for state in (None, st):
        yw, sw = RS.causal_conv1d(j(x), j(w), j(b), None if state is None else j(state))
        yg, sg = S.causal_conv1d(t(x), t(w), t(b), None if state is None else t(state))
        assert rel_err(yg, yw) <= TOL and rel_err(sg, sw) <= TOL
    sw, sg = j(st), t(st)
    for s in range(7):
        yw, sw = RS.conv1d_decode_step(j(x[:, s]), j(w), j(b), sw)
        yg, sg = S.conv1d_decode_step(t(x[:, s]), t(w), t(b), sg)
        assert rel_err(yg, yw) <= TOL
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))


def test_mamba_train_and_decode():
    cfg = ref_get_config("mamba2-370m").reduced()
    pj, pt = both(RS.mamba_init(jax.random.PRNGKey(3), 64, cfg.ssm))
    rng = np.random.default_rng(10)
    x = randn(rng, 2, 13, 64)  # 13 over chunk 8: a ragged tail
    yw, (hw, cw) = jax.jit(lambda p, x: RS.mamba_train(p, x, cfg, return_state=True))(pj, j(x))
    yg, (hg, cg) = S.mamba_train(pt, t(x), get_config("mamba2-370m").reduced(), return_state=True)
    assert rel_err(yg, yw) <= TOL and rel_err(hg, hw) <= TOL and rel_err(cg, cw) <= TOL
    cache_w, cache_g = {"h": hw, "conv": cw}, {"h": hg, "conv": cg}
    decode = jax.jit(lambda p, x, c: RS.mamba_decode(p, x, c, cfg))
    for s in range(3):
        x1 = randn(rng, 2, 1, 64)
        yw, cache_w = decode(pj, j(x1), cache_w)
        yg, cache_g = S.mamba_decode(pt, t(x1), cache_g, cfg)
        assert rel_err(yg, yw) <= TOL and rel_err(cache_g["h"], cache_w["h"]) <= TOL


def test_init_distributions():
    """The port draws its own numbers with the reference's distributions:
    truncated normal on [-2, 2] / sqrt(d_in), embeddings normal x 0.02."""
    g = torch.Generator().manual_seed(0)
    w = L.dense_init(400, 300, generator=g, device="cpu")
    assert float(w.abs().max()) <= 2.0 / np.sqrt(400) + 1e-7
    assert abs(float(w.std()) * np.sqrt(400) - 0.8796) < 0.01  # std of N(0,1) cut to [-2, 2]
    e = L.embed_init(500, 200, generator=g, device="cpu")
    assert abs(float(e.std()) - 0.02) < 5e-4
    m = L.dense_init(400, 300, generator=g, device="meta")
    assert m.device.type == "meta" and m.shape == (400, 300)
