"""The train step's options against the JAX package (`make_train_step`
with 2 microbatches and float32 accumulation, fsdp's default bfloat16
accumulation, int8 error feedback on a dense and an MoE arch, bfloat16
compute, an MoE arch dropping assignments in both dispatch modes), and
the port's own properties: remat off, per layer and grouped give
bit-identical losses and gradients; 1 and 4 microbatches agree as in
tests/test_train.py::test_microbatch_equals_full_batch; the compute-dtype
cast reaches the leaves the reference's `cast_params` reaches."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.stacks import members, rank, reference_leaves
from repro_torch.train.train_step import cast_leaves, init_train_state, make_train_step, value_and_grad
from test_torch_train_step import (check_gradients, check_params, check_steps, flat, port_steps,  # noqa: F401
                                   reference_run, two_torch_threads, with_memory)

# int8 error feedback: a gradient element within rounding of a quantization
# boundary rounds to neighbouring int8 levels in the two packages; its
# dequantized gradient then differs by one quantum (scale = max|g+e|/127),
# which Adam carries into the parameters.  Measured: grad_norm 2.1e-5 at
# step 4 (phi3.5-moe), parameters 4.9e-4 (its experts).
TOL_GNORM_INT8, TOL_PARAM_INT8 = 1e-4, 2e-3
# ... and the residual of such an element differs by that quantum.  Any
# other element's residual differs by the gradients' own gap, a small part
# of a quantum: at most a share MAX_FLIPPED of each residual's elements
# differ by more than TOL_EF_QUANTUM quanta, none by more than one.
MAX_FLIPPED, TOL_EF_QUANTUM = 0.01, 1e-2
# bfloat16 compute on both sides: activations, gradients and the
# accumulator round to 8 bits (2^-8 relative) in other orders, and Adam
# normalizes the rounded gradients.  Measured: loss 5.7e-5, grad_norm
# 1.1e-3, parameters 7.9e-3 (blocks.0.mlp.wd) and 3.5e-2 (embed).
TOL_LOSS_BF16, TOL_GNORM_BF16, TOL_PARAM_BF16, TOL_EMBED_BF16 = 3e-4, 1e-2, 3e-2, 1e-1


# fsdp's default accumulation, bfloat16 (2 microbatches, accum_dtype left to
# the default in both packages): the accumulated gradient rounds to 8 bits
# in both, in their own orders, and Adam normalizes it.  Measured on the
# CPU: grad_norm 6.2e-6 at step 2, parameters 1.75e-4 (blocks.0.mlp.wd),
# 8.5e-5 (embed), 7.0e-5 (blocks.0.attn.wq), 3.4e-5 (blocks.0.mlp.wu); the
# others within a third of TOL_PARAM.
PARAM_TOL_BF16_ACCUM = {"blocks.0.mlp.wd": 6e-4, "embed": 3e-4, "blocks.0.attn.wq": 3e-4, "blocks.0.mlp.wu": 1.5e-4}


# The dry run's optimizer for fsdp archs (launch/dryrun.py `build_cell`, the
# reference's dryrun.py:166-170): a factored second moment and bfloat16
# moments.  Measured on the CPU: steps within 1.8e-7, parameters 1.66e-4
# (embed; its rare rows' near-zero gradients, as PARAM_TOL's embeddings),
# 4.5e-5 (blocks.0.attn.wo), the others 4.4e-5 or less.
PARAM_TOL_FACTORED_BF16 = {"embed": 5e-4}


def test_factored_v_bfloat16_state_matches_reference():
    """fsdp on, factored_v and state_dtype "bfloat16" in both packages."""
    opt = dict(factored_v=True, state_dtype="bfloat16")
    run = reference_run("qwen3-0.6b", grads=False, overrides={"fsdp": True}, opt=opt)
    steps, final = port_steps(run)
    check_steps(run, steps)
    check_params(run, final, named={(run.arch, k): v for k, v in PARAM_TOL_FACTORED_BF16.items()})


def test_microbatches_2_bfloat16_accumulation_matches_reference():
    """fsdp on, accum_dtype not given: both packages accumulate the two
    microbatches' gradients in bfloat16 (ref train_step.py:86-87)."""
    kw = dict(num_microbatches=2)
    run = reference_run("qwen3-0.6b", grads=False, overrides={"fsdp": True}, **kw)
    steps, final = port_steps(run, **kw)
    check_steps(run, steps)
    check_params(run, final, named={(run.arch, k): v for k, v in PARAM_TOL_BF16_ACCUM.items()})


def test_microbatches_2_float32_match_reference():
    kw = dict(num_microbatches=2, accum_dtype="float32")
    run = reference_run("qwen3-0.6b", grads=False, **kw)
    steps, final = port_steps(run, **kw)
    check_steps(run, steps)
    check_params(run, final)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3.5-moe-42b-a6.6b"])
def test_compressed_gradients_match_reference(arch):
    run = reference_run(arch, grads=False, compress_grads=True)
    steps, final = port_steps(run, compress_grads=True)
    check_steps(run, steps, tol={"grad_norm": TOL_GNORM_INT8})
    check_params(run, final, tol=TOL_PARAM_INT8, named={})
    check_residuals(run, final)


def check_residuals(run, final: dict) -> None:
    """The error-feedback residuals against the reference's, in quanta."""
    assert sorted(final["ef"]) == sorted(run.final["ef"])
    for name, want in run.final["ef"].items():
        quantum = 2 * np.abs(want).max()  # |residual| <= scale / 2
        gap = np.abs(final["ef"][name] - want) / max(quantum, 1e-30)
        assert (gap > TOL_EF_QUANTUM).mean() <= MAX_FLIPPED, (name, (gap > TOL_EF_QUANTUM).mean())
        assert gap.max() <= 1.01, (name, gap.max())


def test_bfloat16_compute_matches_reference():
    run = reference_run("qwen3-0.6b", grads=False, compute_dtype="bfloat16")
    steps, final = port_steps(run)
    check_steps(run, steps, tol={"loss": TOL_LOSS_BF16, "ce": TOL_LOSS_BF16, "grad_norm": TOL_GNORM_BF16})
    check_params(run, final, tol=TOL_PARAM_BF16, named={(run.arch, "embed"): TOL_EMBED_BF16})


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b", "whisper-large-v3"])
def test_cast_reaches_the_reference_leaves(arch):
    """bfloat16 compute: the float32 leaves of rank 2 or more in the
    reference's stacked tree (a layer's vector counts the layer axis) are
    cast, the others stay float32; the ranks are the reference's, leaf for
    leaf."""
    cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="bfloat16")
    state = init_train_state(cfg, AdamWConfig(), device="cpu")
    leaves = reference_leaves(cast_leaves(state.params, cfg), cfg.period)
    ref = RT.abstract_params(dataclasses.replace(ref_get_config(arch).reduced(), compute_dtype="bfloat16"))
    assert {name: rank(leaf) for name, leaf in leaves.items()} == {
        name: len(shape) for name, shape in flat_shapes(ref).items()}
    for name, leaf in leaves.items():
        want = torch.bfloat16 if rank(leaf) >= 2 else torch.float32
        assert all(t.requires_grad and t.dtype == want for t in members(leaf)), name


def flat_shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in flat(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)).items()}


def _grads(cfg, state, batch):
    return value_and_grad(cfg, cast_leaves(state.params, cfg), batch, attn_chunk=8)


@pytest.mark.parametrize("arch,layers", [("qwen3-0.6b", 4), ("jamba-v0.1-52b", None), ("whisper-large-v3", 4)])
def test_remat_is_bit_identical(arch, layers):
    """Remat off, per layer and grouped (remat_group=2: groups of 2
    repeats) give the same loss, metrics and gradients bit for bit."""
    base = get_config(arch).reduced()
    if layers:
        base = dataclasses.replace(base, n_layers=layers, encoder_layers=layers if base.encoder_layers else 0)
    state = init_train_state(base, AdamWConfig(), device="cpu")
    pipe = TokenPipeline(base.vocab, 16, 4, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in with_memory(base, pipe.batch(0), 0, 0).items()}
    outs = []
    for remat, group in ((False, 0), (True, 0), (True, 2)):
        cfg = dataclasses.replace(base, remat=remat, remat_group=group)
        outs.append(_grads(cfg, state, batch))
    (l0, m0, g0) = outs[0]
    for loss, metrics, grads in outs[1:]:
        assert torch.equal(loss, l0) and all(torch.equal(metrics[k], m0[k]) for k in m0)
        assert all(torch.equal(grads[k], g0[k]) for k in g0)


def test_microbatch_equals_full_batch():
    """tests/test_train.py::test_microbatch_equals_full_batch for the port:
    float32 accumulation over 4 microbatches against one batch, up to the
    CE mean's nonlinearity (equal microbatch token counts)."""
    cfg = get_config("qwen3-0.6b").reduced()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    s1 = init_train_state(cfg, opt, device="cpu")
    s2 = init_train_state(cfg, opt, device="cpu")
    batch = TokenPipeline(cfg.vocab, 16, 4, seed=0).batch(0)
    n1, m1 = make_train_step(cfg, opt, num_microbatches=1, attn_chunk=8, accum_dtype="float32")(s1, batch)
    n2, m2 = make_train_step(cfg, opt, num_microbatches=4, attn_chunk=8, accum_dtype="float32")(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for (k, a), (_, b) in zip(n1.params.named_parameters(), n2.params.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


def test_accumulation_dtype_follows_fsdp():
    """bfloat16 accumulation by default for fsdp archs, float32 otherwise:
    the accumulated gradient the optimizer sees."""
    seen = {}
    real = TS.adamw_update

    def spy(params, grads, state, cfg):
        seen["dtype"] = members(next(iter(grads.values())))[0].dtype
        return real(params, grads, state, cfg)

    for fsdp, want in ((True, torch.bfloat16), (False, torch.float32)):
        cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), fsdp=fsdp)
        state = init_train_state(cfg, AdamWConfig(), device="cpu")
        batch = TokenPipeline(cfg.vocab, 8, 4, seed=0).batch(0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TS, "adamw_update", spy)
            make_train_step(cfg, AdamWConfig(), num_microbatches=2, attn_chunk=8)(state, batch)
        assert seen["dtype"] == want


# Dropped assignments (capacity_factor under the expert count, which
# `reduced()` sets so that nothing drops): the same assignments drop in both
# packages and the combine reads them as zero.  Measured on the CPU (both
# dispatch modes): the first batch drops 123 and 115 of each layer's 512
# assignments at capacity_factor 1.0, 277 and 292 at 0.5; gradients within
# 1.23e-6 of each leaf's largest, steps within 7.7e-7, parameters after 4
# steps within 2.12e-4 (lm_head, 1.0), the others within 6.7e-5.
PARAM_TOL_MOE_DROPS = {"lm_head": 6e-4}


@pytest.fixture
def dropped(monkeypatch) -> list:
    """The port's dropped assignments, one count per dispatch call."""
    from repro_torch.models import moe

    counts = []
    remap, slots = moe.dispatch_remap, moe.onehot_slots

    def counting_remap(*a, **k):
        buffers, meta = remap(*a, **k)
        counts.append(int((~meta["keep"]).sum()))
        return buffers, meta

    def counting_slots(*a, **k):
        slot, keep = slots(*a, **k)
        counts.append(int((~keep).sum()))
        return slot, keep

    monkeypatch.setattr(moe, "dispatch_remap", counting_remap)
    monkeypatch.setattr(moe, "onehot_slots", counting_slots)
    return counts


@pytest.mark.parametrize("dispatch", ["remap", "onehot"])
@pytest.mark.parametrize("capacity_factor", [1.0, 0.5])
def test_moe_drops_match_reference(capacity_factor, dispatch, dropped):
    run = reference_run("phi3.5-moe-42b-a6.6b", moe=dict(capacity_factor=capacity_factor, dispatch=dispatch))
    check_gradients(run)
    assert dropped and sum(dropped) > 0, dropped
    steps, final = port_steps(run)
    check_steps(run, steps)
    check_params(run, final, named={(run.arch, k): v for k, v in PARAM_TOL_MOE_DROPS.items()})
