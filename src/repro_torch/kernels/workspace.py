"""The `PlannedWorkspace` protocol: what a planned decomposition workspace
does that is not format-specific.  Counterpart of the single-device half of
`repro.kernels.workspace`:

  * rank padding and device-resident factors (`pad_factors` /
    `unpad_factors` / `padded_rows` / `rank_pads`), parameterized by each
    mode's true lane width `lane_ranks`;
  * the layouts' device memory (`plan_bytes`, `planned_layout_bytes`) and
    a plan's layout back as a COO stream (`plan_stream`), for the fallback
    sweeps that keep no stream of their own;
  * `drive`, the host loop: pad once, one sweep per iteration, the
    host-side tol early exit on the fit scalar, unpad at the end; traced
    as a `drive` span with one `sweep` span per iteration (carrying the
    PMS-predicted sweep time while a tracer is active) and recorded in the
    `drive.*` metrics; with the resilience surface: numerical guards
    (`GuardConfig`: raise, restart from jittered factors, or fall back to
    the format's plain reference sweep) and checkpoint/resume.

The port's sweeps write each mode's new factor in place into the padded
tensors they are given, where the reference's return new arrays.  So the
fallback's rebase target, the iterate before the one that failed, is a
copy, taken before each sweep while a fallback can still fire.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..core.loop import DecompositionDiverged, GuardState, finish_iter
from ..core.remap import BlockPlan
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .mttkrp import pad_factor, rank_padded

__all__ = ["PlannedWorkspace", "planned_layout_bytes", "plan_stream"]


def plan_stream(plan: BlockPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """A COO stream equivalent to a plan's layout, on the plan's device:
    (slots, nmodes) int32 coordinates and (slots,) values, for the fallback
    sweeps whose drivers keep no raw stream (Tucker's sweep takes none).
    Padding slots carry value 0 and in-bounds coordinates, so they add
    nothing to any sum.  The reference's arrays, to the bit."""
    blk = plan.blk
    cols = {plan.mode: (torch.repeat_interleave(plan.block_it.long(), blk) * plan.tile_i
                        + plan.iloc.long())}
    for n, im in enumerate(plan.in_modes):
        cols[im] = (torch.repeat_interleave(plan.block_in[n].long(), blk) * plan.in_tiles[n]
                    + plan.in_locs[n].long())
    idx = torch.stack([cols[m] for m in range(1 + plan.n_in)], dim=1).to(torch.int32)
    return idx, plan.vals


def planned_layout_bytes(ops: dict[int, Any]) -> int:
    """Device memory held by a per-mode plan family's layouts (the paper's
    'copies' trade, Sec. 3), at each mode's Remapper element widths: every
    slot's value and its N coordinates, and every block's N tile ids."""
    total = 0
    for op in ops.values():
        p, r = op.plan, op.cfg.remapper
        total += p.vals.shape[0] * (r.value_bytes + (1 + p.n_in) * r.index_bytes)
        total += p.nblocks * (1 + p.n_in) * r.index_bytes
    return total


def _factors_finite(facs: Sequence[torch.Tensor]) -> bool:
    """Whether every factor is finite: one host sync for the whole tuple."""
    return bool(torch.stack([torch.isfinite(f).all() for f in facs]).all())


def _jitter_factors(factors: Sequence[torch.Tensor], attempt: int) -> list[torch.Tensor]:
    """A restart's initial factors: the original ones plus a small relative
    jitter, 1e-4 of each factor's population standard deviation, drawn from
    a `torch.Generator` on the factor's device seeded by the attempt and the
    factor's index.  Staying near the original start keeps the restarted
    run in the clean run's basin.  (The reference draws its jitter from
    `jax.random`; the numbers differ, the rule is the same.)"""
    out = []
    for i, f in enumerate(factors):
        gen = torch.Generator(device=f.device).manual_seed(((0x5EED + attempt) << 16) + i)
        scale = 1e-4 * (torch.std(f, correction=0) + 1e-12)
        out.append(f + scale * torch.randn(f.shape, generator=gen, device=f.device, dtype=f.dtype))
    return out


def _plan_device_arrays(plan: BlockPlan, device: torch.device) -> BlockPlan:
    """The plan with every array on `device`, in the flat contiguous layout
    the kernel reads (plans built by `plan_blocks` already are)."""

    def move(t: torch.Tensor) -> torch.Tensor:
        return t.to(device).contiguous()

    return dataclasses.replace(
        plan,
        vals=move(plan.vals),
        iloc=move(plan.iloc),
        in_locs=tuple(move(t) for t in plan.in_locs),
        block_it=move(plan.block_it),
        block_in=tuple(move(t) for t in plan.block_in),
    )


def _padded_rows_from(geoms: dict[int, Any], nmodes: int) -> tuple[int, ...]:
    """Row padding of each mode's factor: the largest padding any plan needs
    of it (its own plan's out_rows, and in_rows wherever it is an input)."""
    rows = []
    for m in range(nmodes):
        r = geoms[m].out_rows
        for g in geoms.values():
            for n, im in enumerate(g.in_modes):
                if im == m:
                    r = max(r, g.in_rows[n])
        rows.append(r)
    return tuple(rows)


class PlannedWorkspace:
    """Base of every planned workspace.

    Subclasses provide `shape`, `ops` (one planned op per output mode),
    `lane_ranks`, `_geoms()` and `sweep(facs, *args, first)`, which takes
    the padded factor tuple and returns (padded factors, aux, fit); and,
    for the "fallback" guard policy, `_build_fallback_sweep()`.  Padding
    rows and lanes are exactly zero on entry and stay exactly zero, so
    grams and fits taken on the true slices see the true factors."""

    _fallback_fn = None  # built on the first fallback

    @property
    def nmodes(self) -> int:
        return len(self.shape)

    @property
    def lane_ranks(self) -> tuple[int, ...]:
        raise NotImplementedError

    @property
    def rank_pads(self) -> tuple[int, ...]:
        return tuple(rank_padded(r) for r in self.lane_ranks)

    @property
    def padded_rows(self) -> tuple[int, ...]:
        return _padded_rows_from(self._geoms(), self.nmodes)

    def _geoms(self) -> dict[int, Any]:
        raise NotImplementedError

    def _layout_bytes(self) -> int:
        return planned_layout_bytes(self.ops)

    def plan_bytes(self) -> int:
        """Device memory held by the per-mode layouts (the 'copies' trade,
        Sec. 3)."""
        return self._layout_bytes()

    def smem_model_bytes(self) -> int:
        """Shared memory per CTA of the workspace's widest kernel launch, as
        `core/memctrl.py` models it: the third term of the admission total
        (`repro_torch.resilience.admission_bytes`), where the reference
        counts its kernels' VMEM.  Format classes supply it; 0 here."""
        return 0

    def sweep(self, facs, *args, first: bool = False):
        raise NotImplementedError

    def _sweep_call(self, facs, *args, it: int):
        """`drive`'s per-iteration hook, which the fault injectors of
        `repro_torch.testing.faults` wrap."""
        return self.sweep(facs, *args, first=(it == 0))

    def _build_fallback_sweep(self):
        """The format's plain reference sweep as a callable `(facs, *args,
        it) -> (facs, aux, fit)` on the same padded factors: the target of
        the "fallback" guard policy.  None where there is none."""
        return None

    def _fallback_sweep(self):
        if self._fallback_fn is None:
            self._fallback_fn = self._build_fallback_sweep()
        return self._fallback_fn

    def pad_factors(self, factors: Sequence) -> tuple[torch.Tensor, ...]:
        """One pad per mode for the whole decomposition (arrays are taken
        as float32 on the workspace's device)."""
        return tuple(
            pad_factor(f if isinstance(f, torch.Tensor)
                       else torch.as_tensor(np.asarray(f, np.float32), device=self.device),
                       rows, rp)
            for f, rows, rp in zip(factors, self.padded_rows, self.rank_pads)
        )

    def unpad_factors(self, padded: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [f[:s, :r].clone() for f, s, r in zip(padded, self.shape, self.lane_ranks)]

    def _resume(self, ckpt, facs, label: str, verbose: bool):
        """The latest checkpoint's padded factors, fits and next iteration,
        or None where there is none.  Raises where it was written for other
        padded shapes or lane ranks (both pad alike below a lane width, so
        the true ranks are saved beside the factors)."""
        step = ckpt.latest_step()
        if step is None:
            return None
        step, tree = ckpt.restore(step, device=self.device)
        saved = tuple(tree["facs"])
        want = tuple(tuple(f.shape) for f in facs)
        got = tuple(tuple(f.shape) for f in saved)
        saved_lr = tuple(int(r) for r in tree["lane_ranks"].reshape(-1).tolist())
        if got != want or saved_lr != tuple(self.lane_ranks):
            raise ValueError(
                f"checkpoint at {ckpt.dir!r} holds padded factors of shapes {got} (lane ranks "
                f"{saved_lr}) but this workspace pads to {want} (lane ranks "
                f"{tuple(self.lane_ranks)}); it was written by a different tensor/rank/workspace")
        fits = [float(f) for f in tree["fits"].reshape(-1).tolist()]
        _metrics.counter("resilience.resumes", label=label).inc()
        _trace.event("checkpoint_resume", label=label, step=int(step))
        if verbose:
            print(f"[{label}] resumed from checkpoint step {step} ({len(fits)} fits recorded)")
        return saved, fits, int(step) + 1

    def drive(self, factors, args=(), *, iters: int, tol=None, verbose: bool = False,
              label: str = "decompose", guards=None, reinit=None,
              checkpoint_every: int | None = None, checkpoint_path=None):
        """Pad once, one sweep per iteration (the first with the
        first-iteration convention), stop early on `tol` or a non-finite
        fit, unpad.  Returns (true-shape factors, aux of the last sweep,
        fit history).

        guards: a `GuardConfig`.  Each fit feeds the divergence tracker,
          and every `check_factors_every` iterations the factors are
          checked for non-finite entries.  When it fires, the policy raises
          `DecompositionDiverged`; restarts from `reinit(attempt)` (true-shape
          factors) or else the original factors with a 1e-4 jitter, at most
          `max_restarts` times; or switches to the format's reference sweep
          for the rest of the run, redoing the iteration on the last good
          iterate (the one before, where the current one is not finite).
          Each action emits its trace event (`guard_restart`,
          `guard_fallback`, `guard_diverged`) and counter
          (`resilience.restarts`, `.fallbacks`, `.diverged`).  Only a
          numerical divergence fires a guard: an exception from a kernel's
          build or launch passes through.
        checkpoint_every / checkpoint_path: save the padded factors, the
          fits and the lane ranks every k iterations (1 by default) and at
          the last one, under a `checkpoint_save` span; a directory that
          already holds a checkpoint resumes from it (`checkpoint_resume`
          event, `resilience.resumes` counter).

        Each sweep's span encloses the fit's transfer to the host, so it
        ends after the sweep's device work; `drive.iter_seconds` times the
        same interval."""
        gs = GuardState(guards) if guards is not None else None
        fits: list[float] = []
        facs = self.pad_factors(factors)
        aux = None
        sweep_call = self._sweep_call
        fb_active = False

        ckpt = None
        start = 0
        if checkpoint_path is not None:
            from ..train.checkpoint import CheckpointManager

            if checkpoint_every is None:
                checkpoint_every = 1
            elif checkpoint_every < 1:
                raise ValueError("checkpoint_every must be >= 1")
            ckpt = CheckpointManager(checkpoint_path, keep=2)
            resumed = self._resume(ckpt, facs, label, verbose)
            if resumed is not None:
                facs, fits, start = resumed
        elif checkpoint_every is not None:
            raise ValueError("checkpoint_every requires checkpoint_path")

        m_iter = _metrics.histogram("drive.iter_seconds", label=label)
        m_delta = _metrics.histogram("drive.fit_delta", label=label)
        m_count = _metrics.counter("drive.iterations", label=label)
        predicted_s = self._predicted_sweep_s() if _trace.active() is not None else None

        it = start
        prev_facs = None  # a copy of the last accepted sweep's input: the fallback's rebase target
        with _trace.span("drive", label=label, iters=iters, start=start):
            while it < iters:
                # The sweep overwrites `facs`: keep its input while a
                # fallback could still need it.
                keep = (tuple(f.clone() for f in facs)
                        if gs is not None and gs.cfg.policy == "fallback" and not fb_active
                        else None)
                t_sweep = time.perf_counter()
                with _trace.span("sweep", label=label, it=it, predicted_s=predicted_s):
                    new_facs, aux, fit = sweep_call(facs, *args, it=it)
                    fit = float(fit)
                m_iter.observe(time.perf_counter() - t_sweep)
                m_count.inc()
                if fits:
                    m_delta.observe(fit - fits[-1])
                reason = None
                if gs is not None:
                    reason = gs.observe_fit(fit)
                    if (reason is None and gs.cfg.check_factors_every > 0
                            and (it + 1) % gs.cfg.check_factors_every == 0
                            and not _factors_finite(new_facs)):
                        reason = "non-finite factor entries"
                if reason is not None:
                    policy = gs.cfg.policy
                    if policy == "restart" and gs.restarts < gs.cfg.max_restarts:
                        gs.restarts += 1
                        _metrics.counter("resilience.restarts", label=label).inc()
                        _trace.event("guard_restart", label=label, it=it, reason=reason,
                                     attempt=gs.restarts)
                        if verbose:
                            print(f"[{label}] iter {it:3d} {reason}; restart "
                                  f"{gs.restarts}/{gs.cfg.max_restarts} with jittered re-init")
                        base = (reinit(gs.restarts) if reinit is not None
                                else _jitter_factors(factors, gs.restarts))
                        facs = self.pad_factors(base)
                        fits = []
                        gs.reset()
                        it = 0
                        continue
                    if policy == "fallback" and not fb_active:
                        fb = self._fallback_sweep()
                        if fb is not None:
                            fb_active = True
                            sweep_call = fb
                            gs.reset()
                            _metrics.counter("resilience.fallbacks", label=label).inc()
                            _trace.event("guard_fallback", label=label, it=it, reason=reason)
                            # Redo this iteration from its input; where that
                            # input is itself corrupt (poisoned after its fit
                            # was accepted), redo the iteration before it.
                            facs = keep
                            if not _factors_finite(facs) and prev_facs is not None:
                                facs = prev_facs
                                if fits:
                                    fits.pop()
                                it -= 1
                            if verbose:
                                print(f"[{label}] iter {it:3d} {reason}; degrading to the "
                                      f"reference sweep on the last good factors")
                            continue
                        reason += " (no reference fallback sweep for this workspace)"
                    elif policy == "fallback":
                        reason += " (already running the reference fallback)"
                    elif policy == "restart":
                        reason += f" (restart budget of {gs.cfg.max_restarts} exhausted)"
                    _metrics.counter("resilience.diverged", label=label).inc()
                    _trace.event("guard_diverged", label=label, it=it, reason=reason)
                    raise DecompositionDiverged(label, it, reason, fits + [fit])
                prev_facs, facs = keep, new_facs
                stop = finish_iter(fits, fit, it, tol, verbose, label)
                if ckpt is not None and (stop or it + 1 == iters or (it + 1) % checkpoint_every == 0):
                    with _trace.span("checkpoint_save", label=label, it=it):
                        ckpt.save(it, {"facs": facs, "fits": np.asarray(fits, np.float64),
                                       "lane_ranks": np.asarray(self.lane_ranks, np.int64)})
                if stop:
                    break
                it += 1
        return self.unpad_factors(facs), aux, fits

    def _predicted_sweep_s(self) -> float | None:
        """PMS-predicted seconds of one sweep where the workspace has the
        `pms_estimates` hook (PlannedCPALS / PlannedTucker / PlannedTT):
        the sum of its modes' exact t_total; None otherwise.  Attached to
        traced sweep spans, so a trace alone carries what
        `obs.calibrate.join_trace` needs."""
        hook = getattr(self, "pms_estimates", None)
        if hook is None:
            return None
        return float(sum(e.t_total for e in hook().values()))
