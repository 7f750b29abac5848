"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's (`repro.launch.dryrun`), on the CPU:

  * the cell policy (`skip_reason`, `default_microbatches` on duck-typed
    meshes, `auto_remat_group`, `get_n_reps`) equals the reference's for
    every arch x shape x production mesh (the argument bytes of the 60
    full cells against the reference: tests/test_torch_dryrun_bytes.py);
  * reduced cells end to end through `run_cell` on a fake 2 x 2 group
    (`MESH_SHAPES` and the configs patched): the reference's record keys,
    `ok`, peak >= arguments, nothing on the CPU;
  * the two mesh faults the production cells found, cut to a few ranks;
  * the collectives counter on hand-made redistributes, and `main`'s lines,
    artifact and exit code.

Every fake group is begun and destroyed by `dryrun.fake_process_group`
inside a test; `no_group_left` checks that none outlives it.
"""
import dataclasses
import json
import os

import pytest
import torch
import torch.distributed as dist

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as RD  # noqa: E402  (sets XLA_FLAGS for the process at import)

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_configs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from test_torch_mesh_specs import MESHES, FakeMesh  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401  (autouse)

ARCHS = list_configs()
RECORD_KEYS = {"arch", "shape", "mesh", "nchips", "ok", "num_microbatches", "memory", "cost", "collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes"}
# The 2 x 2 meshes the end-to-end cells run on, and their small shapes.
SMALL_MESHES = {"single": ((2, 2), ("data", "model")), "multi": ((1, 2, 2), ("pod", "data", "model"))}
SMALL_SHAPES = {"train_4k": ShapeConfig("train_4k", 32, 8, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 32, 8, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
                "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a test left a process group running"


# ---------------------------------------------------------------------------
# the cell policy
# ---------------------------------------------------------------------------


def test_skip_reason_matches_reference():
    assert D.FULL_ATTENTION == RD.FULL_ATTENTION
    for arch in ARCHS:
        for shape in SHAPES:
            assert D.skip_reason(arch, shape) == RD.skip_reason(arch, shape), (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_microbatches_match_reference(arch):
    for mesh_name, shape in MESHES.items():
        for name in SHAPES:
            mesh = FakeMesh(shape)
            want = RD.default_microbatches(ref_get_config(arch), REF_SHAPES[name], mesh)
            assert D.default_microbatches(get_config(arch), SHAPES[name], mesh) == want, (mesh_name, name)


def test_auto_remat_group_and_n_reps_match_reference():
    assert [D.auto_remat_group(n) for n in range(1, 129)] == [RD.auto_remat_group(n) for n in range(1, 129)]
    assert {a: D.get_n_reps(a) for a in ARCHS} == {a: RD.get_n_reps(a) for a in ARCHS}


# ---------------------------------------------------------------------------
# reduced cells end to end, and main
# ---------------------------------------------------------------------------


@pytest.fixture
def small(monkeypatch):
    """`MESH_SHAPES` of 2 x 2 (1 x 2 x 2), the configs reduced (fsdp from
    `small.fsdp`), small shapes."""
    state = type("Small", (), {"fsdp": False})()
    real = C.get_config
    monkeypatch.setattr(M, "MESH_SHAPES", SMALL_MESHES)
    monkeypatch.setattr(C, "get_config", lambda name: dataclasses.replace(real(name).reduced(), fsdp=state.fsdp))
    monkeypatch.setattr(C, "SHAPES", SMALL_SHAPES)
    return state


@pytest.mark.parametrize("arch,shape,fsdp", [("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "train_4k", True),
                                             ("phi3.5-moe-42b-a6.6b", "decode_32k", False),
                                             ("jamba-v0.1-52b", "prefill_32k", False)])
def test_reduced_cell_records(small, tmp_path, arch, shape, fsdp):
    small.fsdp = fsdp
    rec = D.run_cell(arch, shape, multi_pod=False, out_dir=str(tmp_path), attn_chunk=8)
    assert RECORD_KEYS <= set(rec) and rec["ok"] is True and rec["nchips"] == 4
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["cost"]) == {"flops", "bytes_accessed"}
    m = rec["memory"]
    assert m["peak_bytes"] >= m["argument_bytes"] > 0 and m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert set(rec["device_bytes"]) == {"meta"}  # nothing landed on the CPU, or anywhere real
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["collectives"] and all(c["count"] > 0 and c["bytes"] > 0 for c in rec["collectives"].values())
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    if shape == "train_4k":  # the state is updated in place, but for its step counter (4 B); the batch is not
        assert m["argument_bytes"] - m["alias_bytes"] == 2 * (8 // 2) * 32 * 4 + 4
        assert rec["num_microbatches"] == D.default_microbatches(C.get_config(arch), SMALL_SHAPES[shape],
                                                                 FakeMesh({"data": 2, "model": 2}))
    if shape == "decode_32k":  # the KV caches are written in place
        assert 0 < m["alias_bytes"] < m["argument_bytes"]
    with open(tmp_path / f"{arch}__{shape}__single.json") as f:
        assert json.load(f)["memory"] == m


def test_probe_records(small, tmp_path):
    rec = D.run_cell("qwen3-0.6b", "prefill_32k", multi_pod=False, probe=True, out_dir=str(tmp_path), attn_chunk=8)
    assert rec["nchips"] == 4 and rec["mesh"] == "single"
    d1, d2 = rec["probes"]["depth1"], rec["probes"]["depth2"]
    assert 0 < d1["flops"] < d2["flops"] < rec["cost"]["flops"] * 2 and d1["transcendentals"] > 0
    assert rec["probe_meta"] == {"period": 1, "n_reps_full": 2}


@pytest.mark.parametrize("arch,kind,over,moe,mesh_shape,S,B", [
    # heads the model axis does not divide, trained on a mesh whose data
    # axis splits the batch: the row-parallel projection's input gradient
    # came back sharded on the heads' flattened dim (phi4-mini's 24 and
    # whisper's 20 heads on the 16 x 16 mesh)
    ("phi4-mini-3.8b", "train", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 16}, {}, (2, 4), 16, 16),
    # an fsdp MoE decode step: the experts' hidden kept the products'
    # expert-major layout, which the last einsum could not view on a shard
    # (grok-1 and jamba decode on the 16 x 16 mesh)
    ("grok-1-314b", "decode", {"fsdp": True}, {"d_ff": 256}, (2, 2), 16, 8),
])
def test_mesh_faults_the_dry_run_found(arch, kind, over, moe, mesh_shape, S, B):
    """Two faults of the mesh path that only the production cells reached,
    cut to a fake group of a few ranks: each step now runs."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    with D.fake_process_group(mesh_shape[0] * mesh_shape[1]):
        mesh = M.make_host_mesh(*mesh_shape, device_type="cuda")
        fn, args, _ = D.build_cell(cfg, ShapeConfig(kind, S, B, kind), mesh, attn_chunk=8)
        traced = D.trace_cell(fn, args)
    assert traced["memory"]["peak_bytes"] > traced["memory"]["argument_bytes"]


def _fake_1d(world: int):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cuda", (world,), mesh_dim_names=("x",))


def test_collectives_of_hand_made_redistributes():
    """A Shard -> Replicate redistribute is one all-gather whose output is
    the whole tensor; Partial -> Replicate one all-reduce of the local
    tensor; Partial -> Shard one reduce-scatter of the shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    with D.fake_process_group(4):
        mesh = _fake_1d(4)
        x = distribute_tensor(torch.empty((8, 16), device="meta"), mesh, [Shard(0)], src_data_rank=None)
        part = torch.empty((8, 16), device="meta")
        cases = {"gather": (lambda: x.redistribute(mesh, [Replicate()]), {"all-gather": {"count": 1, "bytes": 512}}),
                 "reduce": (lambda: DTensor.from_local(part, mesh, [Partial()]).redistribute(mesh, [Replicate()]),
                            {"all-reduce": {"count": 1, "bytes": 512}}),
                 "scatter": (lambda: DTensor.from_local(part, mesh, [Partial()]).redistribute(mesh, [Shard(0)]),
                             {"reduce-scatter": {"count": 1, "bytes": 128}})}
        for name, (fn, want) in cases.items():
            with D.StepCounters() as c:
                fn()
            assert c.collectives == want, name
    assert D.collective_kind("c10d_functional.all_gather_into_tensor") == "all-gather"
    assert D.collective_kind(torch.ops._dtensor.shard_dim_alltoall) == "all-to-all"
    assert D.collective_kind(torch.ops.aten.mm.default) is None


def test_step_counters_live_bytes_and_flops():
    """Freed storages leave the live count; the peak stays; a product's
    FLOPs are 2 m n k; arguments tracked count from the start."""
    a, b = torch.empty((64, 32), device="meta"), torch.empty((32, 16), device="meta")
    with D.StepCounters() as c:
        c.track([a, b])
        t = a @ b
        u = torch.empty((5000,), device="meta")
        del u
        v = t + 1
    assert c.peak_bytes == (64 * 32 + 32 * 16 + 64 * 16 + 5000) * 4
    assert c.live["meta"] == (64 * 32 + 32 * 16 + 2 * 64 * 16) * 4 and v.shape == t.shape
    assert c.flops == 2 * 64 * 32 * 16
    assert c.bytes_accessed == (64 * 32 + 32 * 16 + 64 * 16) * 4 + 5000 * 4 + 2 * 64 * 16 * 4


def test_main_lines_artifact_and_exit_code(small, tmp_path, capsys):
    out = str(tmp_path)
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", out]) == 0
    assert D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--out", out]) == 0
    assert D.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out", out]) == 1
    lines = capsys.readouterr().out.splitlines()
    ok, skip, fail = (next(ln for ln in lines if ln.startswith(f"[dryrun] {w} ")) for w in ("OK", "SKIP", "FAIL"))
    assert ok.startswith("[dryrun] OK qwen3-0.6b decode_32k single: peak/device=") and " trace=" in ok
    assert "colls=" in ok and "GiB args=" in ok
    assert skip.startswith("[dryrun] SKIP qwen3-0.6b long_500k: long_500k needs sub-quadratic attention")
    assert fail.startswith("[dryrun] FAIL no-such-arch decode_32k: KeyError")
    with open(tmp_path / "qwen3-0.6b__decode_32k__single.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["mesh_device_type"] == "cuda" and rec["nchips"] == 4 and rec["mesh"] == "single"


def test_fake_group_is_left_as_found():
    """Begun where none runs and destroyed on exit, even on an error; a
    running group is used as it is."""
    with pytest.raises(RuntimeError, match="inside"):
        with D.fake_process_group(4):
            assert dist.get_world_size() == 4
            raise RuntimeError("inside")
    assert not dist.is_initialized()
    with D.fake_process_group(2):
        with D.fake_process_group(8):
            assert dist.get_world_size() == 2
        assert dist.is_initialized()
