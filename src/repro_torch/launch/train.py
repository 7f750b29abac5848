"""Fault-tolerant training driver, on one device or on a mesh: the port of
`repro.launch.train`.

Supervisor loop:
  * atomic keep-last-k checkpoints (train/checkpoint.py), async by default;
  * failure detection: any exception in the step loop (or an injected
    ``--fail-at-step``, used by tests) triggers a supervised restart from the
    latest checkpoint, up to ``--max-restarts``;
  * elastic re-mesh: each attempt builds its mesh anew, and checkpoints
    (saved whole) reshard on restore, so a restart onto another mesh shape
    is transparent;
  * straggler watchdog: step times exceeding ``watchdog_factor`` x the
    running median are logged as straggler events;
  * deterministic data: batch i is a pure function of (seed, i), so restarts
    resume the stream exactly (no replays / skips).

It trains on CUDA unless ``--device`` names another device, and raises
when there is no GPU and no ``--device``.  The mesh path (a
``--mesh-data`` x ``--mesh-model`` `DeviceMesh`, one rank per device) runs
when the program runs under a process group: started by torchrun (NCCL on
CUDA, gloo with ``--device cpu``) or begun by the caller.  Without one, a
1 x 1 mesh trains on one device without DTensors, and a larger mesh
raises.  The archs that read a memory stream (whisper's frames, the vision
archs' image patches) raise: the token pipeline has none, and the
reference's trainer feeds them none either.  On a mesh only rank 0 prints.

Examples (reduced config, CPU; drop --device and --reduced on the card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \
      --steps 30 --batch 8 --seq 128 --device cpu --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-0.6b --reduced --device cpu --mesh-data 2 --mesh-model 2 --seq 32 --attn-chunk 8
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

__all__ = ["build", "train_once", "main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--attn-chunk", type=int, default=2048)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--watchdog-factor", type=float, default=3.0)
    ap.add_argument("--fail-at-step", type=int, default=-1, help="inject a failure (tests)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def build(args, mesh=None):
    """(cfg, plan, opt_cfg, step_fn, pipe) for the parsed flags; the step
    runs on `mesh` (a `DeviceMesh`, its plan `make_plan(mesh, cfg)`) where
    given, else off a mesh (`NOPLAN`)."""
    from ..configs import get_config
    from ..data.pipeline import TokenPipeline
    from ..dist.sharding import NOPLAN, make_plan
    from ..train.optimizer import AdamWConfig
    from ..train.train_step import make_train_step

    cfg = get_config(args.arch)
    if cfg.family in ("audio", "vlm"):
        raise ValueError(f"--arch {args.arch}: the trainer has no {cfg.family} memory stream "
                         "(frames or image patches) to feed it; the token pipeline carries tokens only")
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat=not args.no_remat)
    opt_cfg = AdamWConfig(
        lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
        state_dtype="bfloat16" if cfg.fsdp else "float32",
    )
    plan = NOPLAN if mesh is None else make_plan(mesh, cfg)
    step_fn = make_train_step(cfg, opt_cfg, plan, num_microbatches=args.microbatches,
                              attn_chunk=args.attn_chunk, compress_grads=args.compress_grads)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    return cfg, plan, opt_cfg, step_fn, pipe


def mesh_of(args, device):
    """The attempt's mesh: None for the one-device path (no process group
    and a 1 x 1 mesh), else `make_host_mesh` over the process group's
    ranks.  A mesh of more than one device without a process group
    raises."""
    import torch.distributed as dist

    from .mesh import make_host_mesh

    if not dist.is_initialized():
        if args.mesh_data * args.mesh_model > 1:
            raise ValueError(f"--mesh-data {args.mesh_data} --mesh-model {args.mesh_model}: a mesh of "
                             f"{args.mesh_data * args.mesh_model} devices needs as many ranks; start the "
                             f"program with torchrun --nproc-per-node {args.mesh_data * args.mesh_model}")
        return None
    return make_host_mesh(args.mesh_data, args.mesh_model, device_type=device.type)


def _say(msg: str) -> None:
    """Print, on rank 0 only under a process group (every rank runs the
    loop)."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(msg)


def train_once(args, start_attempt: int, out: dict | None = None) -> int:
    """One supervised attempt.  Returns the step reached.  Raises to signal
    a failure the supervisor should handle.  `out`, where given, receives
    the final "state", a "history" of {step, loss, lr, grad_norm, ms} and
    the attempt's "mesh" (None off a mesh)."""
    import torch
    import torch.distributed as dist

    from ..data.pipeline import make_batch_iterator
    from ..device import resolve_device
    from ..train.checkpoint import CheckpointManager, restore_train_state, save_train_state
    from ..train.train_step import init_train_state

    from .mesh import init_from_env

    init_from_env(args.device)  # under torchrun: before the device is chosen
    device = resolve_device(args.device)
    mesh = mesh_of(args, device)
    cfg, plan, opt_cfg, step_fn, pipe = build(args, mesh)
    ckpt = CheckpointManager(args.ckpt_dir, keep=args.keep) if args.ckpt_dir else None
    state = init_train_state(cfg, opt_cfg, generator=torch.Generator(device).manual_seed(args.seed),
                             device=device, compress_grads=args.compress_grads, plan=plan)
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start = restore_train_state(ckpt, state)  # elastic: onto this attempt's mesh
        _say(f"[train] restored step {start} (attempt {start_attempt})")

    history = [] if out is None else out.setdefault("history", [])
    step_times: list[float] = []
    it = make_batch_iterator(pipe, start_index=start, depth=args.prefetch)
    try:
        for step in range(start, args.steps):
            if args.fail_at_step == step and start_attempt == 0:
                raise RuntimeError("injected node failure (--fail-at-step)")
            t0 = time.time()
            state, metrics = step_fn(state, next(it))
            loss = float(metrics["loss"])  # sync point
            dt = time.time() - t0
            step_times.append(dt)
            history.append({"step": step, "loss": loss, "lr": float(metrics["lr"]),
                            "grad_norm": float(metrics["grad_norm"]), "ms": dt * 1e3})
            if len(step_times) >= 5:
                med = statistics.median(step_times[-50:])
                if dt > args.watchdog_factor * med:
                    _say(f"[watchdog] straggler: step {step} took {dt:.2f}s (median {med:.2f}s)")
            if step % args.log_every == 0:
                _say(f"[train] step {step:5d} loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                           f"gnorm={float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save_train_state(ckpt, step + 1, state, blocking=False)
        if ckpt:
            save_train_state(ckpt, args.steps, state, blocking=True)
    finally:
        it.close()
        if ckpt:
            ckpt.wait()  # a save in flight is published before any restart reads
        if mesh is not None:
            dist.barrier()  # ... on rank 0, before any rank reads
    if out is not None:
        out.update(state=state, mesh=mesh)
    return args.steps


def main(argv=None, out: dict | None = None) -> int:
    """Run the supervisor; `out` as for `train_once` (the last attempt's)."""
    args = parse_args(argv)
    for attempt in range(args.max_restarts + 1):
        try:
            reached = train_once(args, attempt, out)
            _say(f"[train] done at step {reached}")
            return 0
        except (RuntimeError, OSError) as e:
            if "no CUDA device" in str(e):
                raise
            _say(f"[supervisor] attempt {attempt} failed: {e}")
            if attempt == args.max_restarts:
                _say("[supervisor] max restarts exceeded")
                return 1
            if not args.ckpt_dir:
                _say("[supervisor] no checkpoint dir; cold restart")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
