"""Build and load the port's CUDA kernels.

Every `kernels/csrc/*.cu` source is compiled at first use by `nvcc` into a
shared library with a plain C interface under `build/kernels/` at the root
of the checkout (listed in .gitignore), and loaded with `ctypes`.  Libraries
are cached by a hash of the source, the shared headers (`csrc/*.cuh`) and
the flags, so an unchanged source is built once.  All sources that need building are compiled in parallel, one
`nvcc` process each.  A failed build or load raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_all", "load", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600


def nvcc_path() -> str:
    """`$CUDA_HOME/bin/nvcc` (default /usr/local/cuda), else nvcc on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def _library(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; return
    {source stem: library path}.  nvcc's output (with `-Xptxas -v`'s
    register and shared-memory report) is kept beside each library as
    `<library>.log`."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    libs = {src.stem: _library(src) for src in sources}
    todo = [(src, libs[src.stem]) for src in sources if not libs[src.stem].is_file()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        Path(str(lib) + ".log").write_text(out)
        if proc.returncode == 0 and tmp.is_file():
            os.replace(tmp, lib)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built on first use)."""
    libs = build_all()
    if name not in libs:
        raise FileNotFoundError(f"no kernel source csrc/{name}.cu in {CSRC_DIR}")
    return ctypes.CDLL(str(libs[name]))
