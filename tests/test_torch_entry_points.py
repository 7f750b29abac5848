"""The port's last names and its entry points against the JAX package's
(`pad_nnz`, `CooBatch`, `default_in_tiles`, `planned_padded_rows`,
`ttmc_ref_dense`, the trace report's table), `random_factors`' own rule,
the package exports, and the new command lines: the calibration CLI on the
CPU, the examples that run in seconds, a --help for the others, and an
error without a GPU unless --device is given."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro.core import coo as rcoo
from repro.core import remap as rremap
from repro.core.memctrl import CacheEngineConfig as RCache
from repro.core.memctrl import MemoryControllerConfig as RConfig
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.core import coo as tcoo
from repro_torch.core import remap as tremap
from repro_torch.core.memctrl import CacheEngineConfig as TCache
from repro_torch.core.memctrl import MemoryControllerConfig as TConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]


def load(rel: str):
    """A script or example of the repo as a module (its `main` callable)."""
    path = ROOT / rel
    name = "_entry_" + path.stem
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def to_port(st) -> tcoo.SparseTensor:
    return tcoo.SparseTensor(st.indices, st.values, st.shape)


# ---------------------------------------------------------------- the names


@pytest.mark.parametrize("multiple", [1, 7, 128, 2000, 4096])
def test_pad_nnz_matches_reference(tiny_tensor, multiple):
    want, got = rcoo.pad_nnz(tiny_tensor, multiple), tcoo.pad_nnz(to_port(tiny_tensor), multiple)
    assert got.shape == want.shape and got.nnz == want.nnz and got.nnz % multiple == 0
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.indices.dtype == want.indices.dtype and got.values.dtype == want.values.dtype


@pytest.mark.parametrize("multiple", [1, 128])
def test_coo_batch_matches_reference_to_device(tensor4d, multiple):
    want = rcoo.to_device(tensor4d, pad_multiple=multiple)
    got = tcoo.CooBatch.from_sparse(to_port(tensor4d), "cpu", pad_multiple=multiple)
    assert (got.shape, got.nnz, got.nmodes) == (want.shape, want.nnz, want.nmodes) == (
        tensor4d.shape, tensor4d.nnz, 4)
    assert got.indices.dtype == torch.int32 and got.values.dtype == torch.float32
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))


@pytest.mark.parametrize("n_in", range(1, 7))
@pytest.mark.parametrize("tiles", [(128, 128), (64, 256), (512, 32)])
def test_default_in_tiles_matches_reference(n_in, tiles):
    assert tremap.default_in_tiles(n_in, *tiles) == rremap.default_in_tiles(n_in, *tiles)


@pytest.mark.parametrize("tiles", [None, (32, 16, 64)])
@pytest.mark.parametrize("fixture", ["tiny_tensor", "tensor4d"])
def test_planned_padded_rows_matches_reference(request, fixture, tiles):
    st = request.getfixturevalue(fixture)
    rcfg = tcfg = None
    if tiles is not None:
        rcfg = RConfig(cache=RCache(tile_i=tiles[0], tile_j=tiles[1], tile_k=tiles[2]))
        tcfg = TConfig(cache=TCache(tile_i=tiles[0], tile_j=tiles[1], tile_k=tiles[2]))
    want = rops.planned_padded_rows(rops.make_planned_cp_als(st, 8, cfg=rcfg).ops, st.nmodes)
    ws = tops.make_planned_cp_als(to_port(st), 8, cfg=tcfg, device="cpu")
    assert tops.planned_padded_rows(ws.ops, st.nmodes) == want == ws.padded_rows


@pytest.mark.parametrize("shape", [(9, 7, 8), (6, 5, 7, 4), (5, 4, 6, 3, 4)], ids=["3", "4", "5"])
def test_ttmc_ref_dense_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    nnz = 200
    idx = np.stack([rng.integers(0, s, nnz) for s in shape], axis=1).astype(np.int32)
    idx[1] = idx[0]  # a repeated coordinate adds up
    vals = rng.standard_normal(nnz)
    ranks = [2, 3, 2, 3, 2][:len(shape)]
    facs = [rng.standard_normal((s, r)) for s, r in zip(shape, ranks)]
    for mode in range(len(shape)):
        want = rref.ttmc_ref_dense(idx, vals, facs, mode, shape[mode])
        got = tref.ttmc_ref_dense(idx, vals, facs, mode, shape[mode])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=1e-12)


def test_ttmc_ref_dense_refuses_other_orders():
    facs = [np.ones((2, 2))] * 6
    with pytest.raises(ValueError, match="3-5 modes"):
        tref.ttmc_ref_dense(np.zeros((1, 6), np.int32), np.ones(1), facs, 0, 2)


def test_random_factors_rule():
    shape, rank = (300, 200, 400), 16
    a = tcoo.random_factors(shape, rank, generator=torch.Generator().manual_seed(3), device="cpu")
    b = tcoo.random_factors(shape, rank, generator=torch.Generator().manual_seed(3), device="cpu")
    c = tcoo.random_factors(shape, rank, generator=torch.Generator().manual_seed(4), device="cpu")
    assert [tuple(f.shape) for f in a] == [(s, rank) for s in shape]
    assert all(f.dtype == torch.float32 and f.device.type == "cpu" for f in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], c[0])
    # N(0, 1) / sqrt(R), drawn from the generator in mode order.
    gen = torch.Generator().manual_seed(3)
    for f, s in zip(a, shape):
        assert torch.equal(f, torch.randn((s, rank), generator=gen) / rank ** 0.5)
    std = torch.cat([f.flatten() for f in a]).std().item()
    assert abs(std * rank ** 0.5 - 1) < 0.03
    d = tcoo.random_factors((5, 6, 7), 4, generator=torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float64)
    assert all(f.dtype == torch.float64 for f in d)


# -------------------------------------------------------------- the exports

EXPORTS = {
    "repro_torch.core": ["cp_als", "frostt_like", "plan_blocks", "search", "GPUSpec", "random_factors",
                         "CooBatch", "BlockPlan", "mttkrp_sharded", "ShardedPMSEstimate"],
    "repro_torch.kernels": ["mttkrp_blocked", "ttmc_blocked", "ttcore_blocked", "make_planned_cp_als",
                            "ShardedPlannedTucker", "make_sharded_planned_tt", "planned_padded_rows", "ttmc_ref_dense",
                            "planned_layout_bytes", "mttkrp_auto"],
    "repro_torch.kernels.ops": ["ShardedPlannedTucker", "ShardedPlannedTT", "make_sharded_planned_tucker",
                                "make_sharded_planned_tt", "planned_layout_bytes"],
    "repro_torch.train": ["AdamWConfig", "TrainState", "adamw_init", "adamw_update", "init_train_state",
                          "make_train_step", "CheckpointManager"],
    "repro_torch.dist": ["batch_pspecs", "batch_specs", "compress_decompress", "dequantize_int8", "param_pspecs",
                         "quantize_int8", "shard", "valid_spec", "planned"],
    "repro_torch.tt": ["tt_auto"],
    "repro_torch.tucker": ["tucker_auto"],
}


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_package_exports_resolve(package):
    mod = importlib.import_module(package)
    for name in list(getattr(mod, "__all__", [])) + EXPORTS[package]:
        assert getattr(mod, name) is not None, f"{package}.{name}"
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_core_imports_light_and_in_any_order():
    # One process, the port's modules dropped before each first import.
    code = """
import importlib, sys
for first in ("repro_torch.core", "repro_torch.kernels.mttkrp", "repro_torch.core.pms", "repro_torch.kernels",
              "repro_torch.api"):
    for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[m]
    importlib.import_module(first)
    import repro_torch.core as c, repro_torch.kernels as k
    for n in c.__all__:
        getattr(c, n)
    for n in k.__all__:
        getattr(k, n)
    lm = [m for m in sys.modules if m.split(".")[:2] in (["repro_torch", "models"], ["repro_torch", "train"],
                                                         ["repro_torch", "configs"], ["repro_torch", "launch"])]
    assert not lm, (first, lm)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


# ----------------------------------------------------------- command lines

TRACE = [
    {"ph": "X", "name": "decompose", "ts": 0.0, "dur": 5000.0, "pid": 1, "tid": 1, "id": 1, "parent": None,
     "args": {}},
    {"ph": "X", "name": "plan_build", "ts": 10.0, "dur": 300.0, "pid": 1, "tid": 1, "id": 2, "parent": 1,
     "args": {"mode": 0}},
    {"ph": "X", "name": "plan_build", "ts": 320.0, "dur": 200.0, "pid": 1, "tid": 1, "id": 3, "parent": 1,
     "args": {"mode": 1}},
    {"ph": "X", "name": "sweep", "ts": 600.0, "dur": 900.0, "pid": 1, "tid": 1, "id": 4, "parent": 1,
     "args": {"label": "cp_als", "preset": "tiny", "predicted_s": 1e-4}},
    {"ph": "X", "name": "sweep", "ts": 1600.0, "dur": 700.0, "pid": 1, "tid": 1, "id": 5, "parent": 1,
     "args": {"label": "cp_als", "preset": "tiny", "predicted_s": 1e-4}},
    {"ph": "i", "name": "plan_cache_miss", "ts": 5.0, "pid": 1, "tid": 1, "id": 6, "parent": 1, "args": {}},
]


@pytest.mark.parametrize("by_mode", [False, True])
def test_trace_report_summary_matches_reference(by_mode):
    want = load("scripts/trace_report.py").summarize(TRACE, by_mode=by_mode)
    assert load("scripts/torch_trace_report.py").summarize(TRACE, by_mode=by_mode) == want
    assert ("plan_build[mode=1]" in want) == by_mode


def test_trace_report_main(tmp_path, capsys):
    import json

    trace = tmp_path / "t.jsonl"
    trace.write_text("".join(json.dumps(r) + "\n" for r in TRACE))
    chrome = tmp_path / "t.json"
    rep = load("scripts/torch_trace_report.py")
    assert rep.main([str(trace), "--pms", "--by-mode", "--chrome", str(chrome), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "plan_build[mode=0]" in out and "cp_als" in out and "chrome trace ->" in out
    assert len(json.loads(chrome.read_text())["traceEvents"]) == len(TRACE)
    (tmp_path / "bad.jsonl").write_text("{not json\n")
    assert rep.main([str(tmp_path / "bad.jsonl"), "--device", "cpu"]) == 1


def test_calibration_cli_on_the_cpu(tmp_path, capsys):
    cal = load("scripts/torch_calibrate.py")
    assert cal.main(["--device", "cpu", "--dry-run", "--reps", "1", "--cache-dir", str(tmp_path)]) == 0
    assert "dry run: cache not written" in capsys.readouterr().out and not any(tmp_path.iterdir())
    before = os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
    out = {}
    assert cal.main(["--device", "cpu", "--reps", "1", "--cache-dir", str(tmp_path), "--check-hit"], out) == 0
    assert "check-hit OK" in capsys.readouterr().out
    from repro_torch.tune import current_backend

    # The fit's own backend, and the process's where they are one.
    assert out["check_hit"] == {"spec_hits": 2 if current_backend() == "cpu" else 1, "spec_misses": 0}
    assert out["cache_path"].parent == tmp_path and out["cache_path"].is_file()
    assert out["result"].backend == "cpu" and out["result"].stream_hbm_bw is None
    assert os.environ.get("REPRO_TORCH_AUTOTUNE_DIR") == before


ENTRY_POINTS = {
    "scripts/torch_calibrate.py": ["--dry-run"],
    "scripts/torch_trace_report.py": ["no-such-trace.jsonl"],
    "examples/quickstart_torch.py": ["--fast"],
    "examples/serve_batch_torch.py": [],
    "examples/train_lm_torch.py": ["--steps", "1"],
    "examples/fault_tolerance_demo_torch.py": [],
    "examples/moe_dispatch_demo_torch.py": [],
}


@pytest.mark.parametrize("rel", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_gpu_and_device(rel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(rel).main(ENTRY_POINTS[rel])


@pytest.mark.parametrize("rel", sorted(ENTRY_POINTS))
def test_entry_point_help(rel, capsys):
    with pytest.raises(SystemExit) as e:
        load(rel).main(["--help"])
    assert e.value.code == 0 and "--device" in capsys.readouterr().out


@pytest.mark.parametrize("algo", ["cp", "tucker", "tt"])
def test_quickstart_sharded_on_the_cpu(algo):
    out = {}
    assert load("examples/quickstart_torch.py").main(
        ["--device", "cpu", "--fast", "--devices", "2", "--algo", algo, "--rank", "4"], out) == 0
    assert out["shards"] == "2 shards in turn on cpu" and len(out["fit_history"]) == 2
    assert max(abs(a - b) for a, b in zip(out["sharded_fit_history"], out["fit_history"])) <= 1e-5


def test_quickstart_auto_tune_cached_then_traced(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path / "cache"))
    q = load("examples/quickstart_torch.py")
    runs = [{}, {}]
    trace = tmp_path / "q.jsonl"
    assert q.main(["--device", "cpu", "--fast", "--auto-tune", "cached"], runs[0]) == 0
    assert q.main(["--device", "cpu", "--fast", "--auto-tune", "cached", "--trace", str(trace)], runs[1]) == 0
    assert runs[0]["configs_evaluated"] > 0 and runs[0]["autotune_cache_hits"] == 0
    assert runs[1]["configs_evaluated"] == 0 and runs[1]["autotune_cache_hits"] == 3
    assert runs[0]["fit_history"] == runs[1]["fit_history"]
    capsys.readouterr()
    assert load("scripts/torch_trace_report.py").main([str(trace), "--pms", "--device", "cpu"]) == 0
    assert "sweep" in capsys.readouterr().out


def test_serve_batch_on_the_cpu():
    out = {}
    assert load("examples/serve_batch_torch.py").main(["--device", "cpu", "--new-tokens", "4"], out) == 0
    assert tuple(out["tokens"].shape) == (4, 4) and out["tokens"].device.type == "cpu"


def test_moe_dispatch_demo_on_the_cpu():
    out = {}
    assert load("examples/moe_dispatch_demo_torch.py").main(["--device", "cpu"], out) == 0
    assert out["max_abs_diff"] < 1e-5
    assert out["onehot"]["bytes"] > out["remap"]["bytes"] > 0 and out["remap"]["flops"] > 0


def test_fault_tolerance_demo_recovers_on_the_cpu(capsys):
    assert load("examples/fault_tolerance_demo_torch.py").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[supervisor] attempt 0 failed" in out and "[train] restored step 8" in out
