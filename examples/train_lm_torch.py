"""End-to-end training example of the PyTorch port: train a ~100M-parameter
qwen3-family model for a few hundred steps on the synthetic Markov corpus,
with checkpoints.  The torch counterpart of `examples/train_lm.py`.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--d-model 512]

~100M params: 12 layers x d_model 512 + 32k vocabulary (tied), float32
compute, no remat.  The loss should fall well below the unigram entropy as
the model learns the bigram chain.  It trains on CUDA unless --device names
another device, and raises without a GPU.  Checkpoints go to --ckpt-dir
(default: repro_torch_train_lm under the temporary directory).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="torch device (default: CUDA; 'cpu' to run there)")
    return ap.parse_args(argv)


def main(argv=None, out: dict | None = None) -> int:
    """Train; `out`, where given, receives the "losses" of every step."""
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline, make_batch_iterator
    from repro_torch.device import resolve_device
    from repro_torch.train import AdamWConfig, CheckpointManager, init_train_state, make_train_step
    from repro_torch.train.checkpoint import save_train_state

    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b"), n_layers=args.layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=4 * args.d_model // 2 * 2, vocab=args.vocab, remat=False, compute_dtype="float32",
    )
    print(f"[train_lm] model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} ~{cfg.param_count()/1e6:.0f}M params")

    opt = AdamWConfig(lr=args.lr, warmup_steps=40, total_steps=args.steps)
    state = init_train_state(cfg, opt, generator=torch.Generator(device).manual_seed(0), device=device)
    step_fn = make_train_step(cfg, opt, num_microbatches=1, attn_chunk=256)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    losses = [] if out is None else out.setdefault("losses", [])

    it = make_batch_iterator(pipe, start_index=0, depth=2)
    t0 = time.time()
    toks_done = 0
    try:
        for step in range(args.steps):
            state, metrics = step_fn(state, next(it))
            losses.append(float(metrics["loss"]))  # sync point
            toks_done += args.batch * args.seq
            if step % 20 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:4d} loss={losses[-1]:7.4f} lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):6.2f} {toks_done/dt:,.0f} tok/s")
            if (step + 1) % 100 == 0:
                save_train_state(ckpt, step + 1, state, blocking=False)
        save_train_state(ckpt, args.steps, state, blocking=True)
    finally:
        it.close()
        ckpt.wait()
    print(f"[train_lm] done; final loss {losses[-1]:.4f} (unigram entropy of the corpus is ~6-7 nats; "
          f"bigram structure should pull CE toward ~2.5)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
