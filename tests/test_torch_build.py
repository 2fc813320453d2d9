"""The port's kernel build (dlrover_tpu_torch/ops/cuda/_build.py) and
timing barrier (dlrover_tpu_torch/utils/timing.py), without a compiler or a
card: a stand-in ``nvcc`` script plays the compiler."""

import os
import stat

import pytest
import torch

from dlrover_tpu_torch.ops.cuda import _build
from dlrover_tpu_torch.utils.timing import hard_block


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A source dir with one kernel and an empty build dir."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def _fake_nvcc(tmp_path, monkeypatch, exit_code):
    """An ``nvcc`` on PATH that writes its ``-o`` file and exits with
    ``exit_code``; it appends one line per call to ``calls``."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    script = bindir / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo call >> {tmp_path / 'calls'}\n"
        "echo 'ptxas info    : Used 8 registers'\n"
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi\n'
        "  shift\n"
        "done\n"
        f"exit {exit_code}\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")


def test_library_is_keyed_by_the_source(workdir):
    first = _build.library_path("k")
    assert first.parent == workdir / "build"
    assert first == _build.library_path("k")
    (workdir / "csrc" / "k.cu").write_text("// kernel v2\n")
    assert _build.library_path("k") != first


def test_library_is_keyed_by_the_headers(workdir):
    """Every csrc/*.cuh is part of each library's key: an edited, added or
    removed header rebuilds what may include it."""
    first = _build.library_path("k")
    header = workdir / "csrc" / "common.cuh"
    header.write_text("// helpers v1\n")
    with_header = _build.library_path("k")
    assert with_header != first
    header.write_text("// helpers v2\n")
    assert _build.library_path("k") != with_header
    header.unlink()
    assert _build.library_path("k") == first


def test_build_compiles_once_and_keeps_the_report(workdir, monkeypatch):
    _fake_nvcc(workdir, monkeypatch, exit_code=0)
    path = _build.build(["k"])["k"]
    assert path.exists() and path == _build.library_path("k")
    assert "Used 8 registers" in _build.build_log("k")
    _build.build(["k"])  # unchanged source: no second compile
    assert (workdir / "calls").read_text().count("call") == 1
    assert not list((workdir / "build").glob("*.tmp"))


def test_failed_build_raises_and_leaves_no_library(workdir, monkeypatch):
    _fake_nvcc(workdir, monkeypatch, exit_code=1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()
    assert not list((workdir / "build").glob("*.tmp"))


def test_missing_compiler_raises(workdir, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(workdir / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["k"])


def test_repo_sources_are_the_ones_built():
    for name in ("flash_attention", "ring_reduce_scatter", "rdma_ring"):
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        assert name in _build.SOURCES
    assert set(_build.SOURCES) == {
        p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_hard_block_returns_the_tree():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (3, "x")]}
    assert hard_block(tree) is tree
