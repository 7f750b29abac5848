"""The port's kernel build (`repro_torch.kernels.build`) without nvcc: every
`csrc/*.cu` source has a library name, and a library's cache key covers its
source, the shared `csrc/*.cuh` headers and the flags, so editing a shared
header rebuilds every kernel that includes it."""
from repro_torch.kernels import build


def test_every_source_has_a_library_in_the_build_dir():
    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    assert sources == ["mttkrp", "ttcore", "ttmc"]
    for stem in sources:
        lib = build._library(build.CSRC_DIR / f"{stem}.cu")
        assert lib.parent == build.BUILD_DIR and lib.name.startswith(f"{stem}-")


def test_cache_key_covers_source_shared_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src, header = tmp_path / "k.cu", tmp_path / "shared.cuh"
    src.write_text('#include "shared.cuh"\n')
    header.write_text("// one\n")
    first = build._library(src)
    assert build._library(src) == first
    header.write_text("// two\n")
    second = build._library(src)
    assert second != first
    src.write_text('#include "shared.cuh"\n// edited\n')
    third = build._library(src)
    assert third not in (first, second)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._library(src) not in (first, second, third)
