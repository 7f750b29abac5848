"""The port's public surface against the JAX package's, read from the source
with `ast` (neither package is imported): every public top-level name of
every reference module, and every name a reference `__init__.py` exports,
has a counterpart of the same name at the same module path in the port,
except the entries of `INTENDED`, each with its reason.  `INTENDED` equals
the list of names in ROADMAP.md's "Intended API differences", and an
entry the port has since ported fails."""
import ast
import re
from pathlib import Path

import pytest
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: The Pallas kernel files and the port's modules of their CUDA kernels.
KERNEL_FILES = {"kernels/mttkrp_pallas.py": "kernels/mttkrp.py", "kernels/ttm_pallas.py": "kernels/ttm.py",
                "kernels/tt_pallas.py": "kernels/tt.py"}

#: "module::name" (or a module directory, "dir/") -> (the port's name for
#: it, or None where it has none; the reason).
INTENDED = {
    "core/memctrl.py::TPUSpec": ("GPUSpec", "the rates and limits of an H100, not of a TPU"),
    "core/__init__.py::TPUSpec": ("GPUSpec", "the rates and limits of an H100, not of a TPU"),
    "core/loop.py::require_sharded_sweep": (None, "the port has no jit_sweep="),
    "launch/dryrun.py::parse_collectives": (
        None, "it parses HLO; the port counts collectives as they are dispatched"),
    "kernels/mttkrp_pallas.py::mttkrp_pallas_call": ("mttkrp_blocked", "the launch of the CUDA MTTKRP kernel"),
    "kernels/ttm_pallas.py::ttmc_pallas_call": ("ttmc_blocked", "the launch of the CUDA TTM-chain kernel"),
    "kernels/tt_pallas.py::ttcore_pallas_call": ("ttcore_blocked", "the launch of the CUDA TT-core kernel"),
    "kernels/__init__.py::mttkrp_pallas_call": ("mttkrp_blocked", "the launch of the CUDA MTTKRP kernel"),
    "kernels/__init__.py::ttmc_pallas_call": ("ttmc_blocked", "the launch of the CUDA TTM-chain kernel"),
    "kernels/__init__.py::ttcore_pallas_call": ("ttcore_blocked", "the launch of the CUDA TT-core kernel"),
    "_compat/": (None, "a stand-in for optional test dependencies of the JAX package"),
}


def _strings(node: ast.AST) -> set[str]:
    return {n.value for n in ast.walk(node) if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.isidentifier()}


def public_names(path: Path, *, port: bool) -> set[str]:
    """Top-level public names of a module: its definitions and assignments
    and the strings of its `__all__`; for an `__init__.py` also what it
    imports.  In the port, what a module imports counts as its name too,
    and so do the names of a lazily exporting package's `_EXPORTS` table."""
    init = path.name == "__init__.py"
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                    if t.id == "__all__" or (port and t.id == "_EXPORTS"):
                        out |= _strings(node.value)
        elif isinstance(node, ast.ImportFrom) and (init or port):
            out |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import) and port:
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not n.startswith("_")}


def ref_modules() -> list[str]:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _skipped(rel: str) -> bool:
    return any(k.endswith("/") and rel.startswith(k) for k in INTENDED)


@pytest.mark.parametrize("rel", ref_modules())
def test_every_public_name_has_a_port_counterpart(rel):
    if _skipped(rel):
        assert not (PORT / rel).exists(), f"{rel} was ported: take its directory out of INTENDED"
        return
    port_path = PORT / KERNEL_FILES.get(rel, rel)
    assert port_path.is_file(), f"no port counterpart of {rel} (looked for {port_path.relative_to(ROOT)})"
    ref, port = public_names(REF / rel, port=False), public_names(port_path, port=True)
    missing = []
    for name in sorted(ref):
        key = f"{rel}::{name}"
        if key in INTENDED:
            counterpart, _ = INTENDED[key]
            assert name not in port, f"{key} is in INTENDED but the port has it now"
            if counterpart is not None:
                assert counterpart in port, f"{key}: the port's {counterpart} is missing"
        elif name not in port:
            missing.append(name)
    assert not missing, f"{rel}: no port counterpart of {missing}"


def test_intended_entries_name_reference_names():
    for key in INTENDED:
        if key.endswith("/"):
            assert (REF / key).is_dir(), key
            continue
        rel, name = key.split("::")
        assert name in public_names(REF / rel, port=False), f"{key} is not a public name of the reference"


def roadmap_intended() -> set[str]:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Intended API differences from the JAX package.**")
    end = text.index("\n### ", start)
    return set(re.findall(r"`((?:\w+/)*\w+\.py::\w+|\w+/)`", text[start:end]))


def test_intended_equals_the_roadmap_list():
    assert roadmap_intended() == set(INTENDED)
