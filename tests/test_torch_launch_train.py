"""`python -m repro_torch.launch.train` on the CPU: the reference's log
lines, the supervisor's restore after an injected failure ending bit for
bit where an uninterrupted run ends, a non-blocking save's snapshot, the
mesh flags, the archs with a memory stream and the device contract."""
import re
import threading

import numpy as np
import pytest
import torch

from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import CheckpointManager

ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "16",
        "--attn-chunk", "8", "--log-every", "2", "--lr", "3e-3", "--warmup", "2"]
STEP_LINE = re.compile(r"^\[train\] step +\d+ loss=\d+\.\d{4} lr=\d\.\d{2}e[-+]\d{2} gnorm=\d+\.\d{2} \d+ms$")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's tests, whatever the machine: the
    suite runs several workers on its cores, and torch's default of a
    thread per core in each turns eager CPU work into contention; and a
    fixed count fixes the float32 summation orders that the measured
    bounds below were taken with (one thread sums in others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def final_tree(path) -> dict:
    step, tree = CheckpointManager(str(path)).restore()
    assert step == 12
    return tree


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_prints_the_reference_lines(capsys, tmp_path):
    assert launch_train.main(ARGS + ["--compress-grads", "--ckpt-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [ln for ln in lines if ln.startswith("[train] step")]
    assert len(steps) == 6 and all(STEP_LINE.match(ln) for ln in steps), steps
    assert lines[-1] == "[train] done at step 12"
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert "ef" in final_tree(tmp_path)["opt"]


def test_restored_run_ends_where_an_uninterrupted_one_does(capsys, tmp_path):
    assert launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a"), "--ckpt-every", "4"]) == 0
    capsys.readouterr()
    assert launch_train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--ckpt-every", "4",
                                     "--fail-at-step", "6", "--max-restarts", "1"]) == 0
    out = capsys.readouterr().out
    assert "[supervisor] attempt 0 failed: injected node failure (--fail-at-step)" in out
    assert "[train] restored step 4 (attempt 1)" in out
    assert out.strip().splitlines()[-1] == "[train] done at step 12"
    a, b = dict(leaves(final_tree(tmp_path / "a"))), dict(leaves(final_tree(tmp_path / "b")))
    assert sorted(a) == sorted(b)
    for k in a:
        if k != "rng":
            assert torch.equal(a[k], b[k]), k


def test_non_blocking_save_is_a_snapshot(monkeypatch, tmp_path):
    """A step that updates the state in place while a non-blocking save is
    still writing does not reach the checkpoint: the save copies every
    leaf, CPU tensors included, before it returns.  The writer is held
    until the state has changed, so the order is not left to the thread."""
    from repro_torch.configs import get_config
    from repro_torch.train.checkpoint import restore_train_state, save_train_state
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state

    cfg, opt = get_config("qwen3-0.6b").reduced(), AdamWConfig()

    def live(state) -> dict:
        return dict(leaves({"params": dict(state.params.named_parameters()), "opt": state.opt}))

    state = init_train_state(cfg, opt, device="cpu", compress_grads=True)
    before = {k: t.detach().clone() for k, t in live(state).items()}
    release, write = threading.Event(), CheckpointManager._write
    monkeypatch.setattr(CheckpointManager, "_write",
                        lambda self, *a: (release.wait(timeout=60), write(self, *a)))
    mgr = CheckpointManager(str(tmp_path))
    save_train_state(mgr, 1, state, blocking=False)
    with torch.no_grad():
        for t in live(state).values():
            t.add_(1)
    release.set()
    mgr.wait()
    fresh = init_train_state(cfg, opt, generator=torch.Generator().manual_seed(1), device="cpu",
                             compress_grads=True)
    assert restore_train_state(mgr, fresh) == 1
    got = live(fresh)
    assert sorted(got) == sorted(before) and "opt.ef.embed" in got
    for k, want in before.items():
        assert torch.equal(got[k], want), k


def test_failure_without_restarts_left(capsys):
    assert launch_train.main(ARGS + ["--fail-at-step", "1", "--max-restarts", "0", "--steps", "3"]) == 1
    out = capsys.readouterr().out
    assert "[supervisor] attempt 0 failed" in out and "[supervisor] max restarts exceeded" in out


def test_mesh_flags_raise():
    """A mesh of more than one device without a process group (no
    torchrun): the launcher cannot start its ranks itself."""
    with pytest.raises(ValueError, match="needs as many ranks"):
        launch_train.main(ARGS + ["--mesh-data", "2"])
    with pytest.raises(ValueError, match="needs as many ranks"):
        launch_train.main(ARGS + ["--mesh-model", "4"])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_memory_stream_archs_raise(arch):
    args = ARGS[:]
    args[1] = arch
    with pytest.raises(ValueError, match="memory stream"):
        launch_train.main(args)


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(args)
