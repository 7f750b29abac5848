"""The port stands alone: no JAX and nothing of the JAX package in
`src/repro_torch/`, `chip_smoke.py`, the port's scripts and examples; and its
device contract — CUDA by default, an error (not a silent CPU run) when
there is no GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.api import decompose
from repro_torch.core import coo as tcoo
from repro_torch.core.remap import plan_blocks
from repro_torch.kernels.mttkrp import mttkrp_blocked
from repro_torch.kernels.ops import make_planned_cp_als, mttkrp_auto, tt_auto, tucker_auto
from repro_torch.kernels.tt import ttcore_blocked
from repro_torch.kernels.ttm import ttmc_blocked
from repro_torch.tt import make_planned_tt, tt_als, tt_svd
from repro_torch.tucker import make_planned_tucker, tucker_hooi
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import generate
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py")) + sorted((ROOT / "scripts").glob("torch_*.py"))


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.tucker, repro_torch.tt, repro_torch.core.pms, repro_torch.tune, "
            "repro_torch.obs.calibrate, repro_torch.resilience, repro_torch.testing.faults, "
            "repro_torch.train.checkpoint, repro_torch.launch.serve, repro_torch.serve.engine, "
            "repro_torch.configs, repro_torch.data.pipeline, repro_torch.dist.compression, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, repro_torch.launch.train, "
            "repro_torch.launch.dryrun, repro_torch.bench, repro_torch.core, repro_torch.kernels, "
            "repro_torch.dist, repro_torch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu_and_device(no_cuda):
    st = tcoo.frostt_like("tiny")
    facs = [torch.ones((s, 4)) for s in st.shape]
    cores = [torch.ones((a, s, b)) for s, (a, b) in zip(st.shape, ((1, 2), (2, 2), (2, 1)))]
    lm = get_config("qwen3-0.6b").reduced()
    lm_params = init_params(lm, device="cpu")
    for call in (lambda: decompose(st, 4),
                 lambda: decompose(st, 4, auto_tune=True),
                 lambda: decompose(st, 4, method="approach1"),
                 lambda: decompose(st, 4, method="approach2", layout="copies"),
                 lambda: decompose(st, 4, format="tucker", method="reference"),
                 lambda: decompose(st, 4, format="tt", method="reference"),
                 lambda: mttkrp_auto(st, facs, 0),
                 lambda: mttkrp_auto(st, facs, 0, method="approach1"),
                 lambda: tucker_auto(st, facs, 0),
                 lambda: tucker_auto(st, facs, 0, method="reference"),
                 lambda: tt_auto(st, cores, 0),
                 lambda: tt_auto(st, cores, 0, method="reference"),
                 lambda: make_planned_cp_als(st, 4),
                 lambda: plan_blocks(st, 0),
                 lambda: decompose(st, 4, format="tucker"),
                 lambda: tucker_hooi(st, (4, 4, 4), method="reference"),
                 lambda: make_planned_tucker(st, (4, 4, 4)),
                 lambda: decompose(st, 4, format="tt"),
                 lambda: tt_als(st, (4, 4), method="reference"),
                 lambda: make_planned_tt(st, (4, 4)),
                 lambda: tt_svd(st, (4, 4)),
                 lambda: init_params(lm),
                 lambda: generate(lm_params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, lm),
                 lambda: launch_serve.main(["--arch", "qwen3-0.6b", "--reduced"]),
                 lambda: init_train_state(lm, AdamWConfig()),
                 lambda: launch_train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert len(decompose(st, 4, iters=1, device="cpu").fit_history) == 1
    assert len(decompose(st, 4, format="tucker", iters=1, device="cpu").fit_history) == 1
    assert len(decompose(st, 4, format="tt", iters=1, device="cpu").fit_history) == 1
    assert len(decompose(st, 4, method="approach1", iters=1, device="cpu").fit_history) == 1
    assert mttkrp_auto(st, facs, 0, device="cpu").device.type == "cpu"
    assert tucker_auto(st, facs, 0, device="cpu").device.type == "cpu"
    assert tt_auto(st, cores, 0, device="cpu").device.type == "cpu"
    assert all(c.device.type == "cpu" for c in tt_svd(st, (4, 4), device="cpu"))
    assert generate(lm_params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, lm, max_new_tokens=2,
                    attn_chunk=4, device="cpu").shape == (1, 2)
    state = init_train_state(lm, AdamWConfig(), device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    state, metrics = make_train_step(lm, AdamWConfig(), attn_chunk=4)(state, {"tokens": toks, "labels": toks})
    assert state.params["embed"].device.type == "cpu" and metrics["loss"].device.type == "cpu"


def test_cpu_run_launches_no_kernel():
    before = mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches
    decompose(tcoo.frostt_like("tiny"), 4, iters=2, device="cpu")
    decompose(tcoo.frostt_like("tiny"), (3, 5, 2), format="tucker", iters=2, device="cpu")
    decompose(tcoo.frostt_like("tiny"), (3, 5), format="tt", iters=2, device="cpu")
    assert (mttkrp_blocked.launches, ttmc_blocked.launches, ttcore_blocked.launches) == before \
        == (0, 0, 0)
