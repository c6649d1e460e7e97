"""The port's recompile guard (``repro_torch.analysis.guard``) on the CPU,
with ``nvcc`` and ``ctypes`` stubbed: a compile is a ``kernels.build.build``
call that ran the compiler, counted per library; loads are recorded and
never budgeted; the surface is the JAX package's (``test_analysis.py``'s
guard cases)."""
import subprocess
import types

import pytest

from repro.analysis import guard as jguard
from repro_torch.analysis import guard
from repro_torch.kernels import build

LIBS = ("coded_kv_decode", "gather_pool", "xor_encode", "xor_gather")


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """``build`` on stub sources in ``tmp_path`` with a stub compiler that
    writes its output; returns the list of compiler command lines."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in LIBS:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    runs = []

    def run(cmd, capture_output, text, timeout):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF stub")
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "ptxas info: stub", "")

    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build, "subprocess", types.SimpleNamespace(run=run))
    monkeypatch.setattr(build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: object()))
    monkeypatch.setattr(build, "COMPILES", {})
    monkeypatch.setattr(build, "LOADS", {})
    monkeypatch.setattr(build, "_LIBS", {})
    return runs


def test_one_build_counts_one(nvcc):
    with guard.recompile_guard("kernels.xor_gather", max_compiles=1) as g:
        build.build("xor_gather")
    assert len(nvcc) == 1
    assert g.compiles() == 1
    assert g.deltas() == {"kernels.xor_gather": 1}
    assert guard.cache_size("kernels.xor_gather") == 1


def test_a_second_build_of_the_same_source_counts_zero(nvcc):
    build.build("xor_encode")
    with guard.recompile_guard("kernels.xor_encode") as g:
        res = build.build("xor_encode")           # the library is reused
    assert res.seconds == 0.0 and len(nvcc) == 1
    assert g.compiles() == 0 and g.deltas() == {"kernels.xor_encode": 0}


def test_over_budget_raises(nvcc):
    with pytest.raises(guard.RecompileError, match="xor_encode"):
        with guard.recompile_guard(max_compiles=0):
            build.build("xor_encode")
    build.build("gather_pool")
    with pytest.raises(guard.RecompileError, match="budget 1"):
        with guard.recompile_guard("kernels.pool_gather",
                                   "kernels.coded_kv_decode",
                                   max_compiles=1):
            build.build("coded_kv_decode")
            (build.CSRC / "gather_pool.cu").write_text("// edited\n")
            build.build("gather_pool")             # the digest changed


def test_record_only_never_raises(nvcc):
    with guard.recompile_guard(max_compiles=None) as g:
        for name in LIBS:
            build.build(name)
    assert g.compiles() == len(LIBS)


def test_a_library_shared_by_targets_counts_once(nvcc):
    """``sweep``, ``stream`` and ``kernels.xor_gather`` all count the
    ``xor_gather`` library: each target's delta is 1, the region built
    one library."""
    with guard.recompile_guard(max_compiles=1) as g:
        build.build("xor_gather")
    assert g.compiles() == 1
    d = g.deltas()
    assert d["sweep"] == d["stream"] == d["kernels.xor_gather"] == 1
    assert d["kernels.xor_encode"] == d["kernels.pool_gather"] == 0


def test_loads_are_recorded_not_budgeted(nvcc):
    for name in LIBS:
        build.build(name)
    with guard.recompile_guard() as g:
        build.library("xor_gather")
        build.library("xor_gather")                # loaded once
        build.library("coded_kv_decode")
    assert g.compiles() == 0
    assert g.loads() == {"coded_kv_decode": 1, "gather_pool": 0,
                         "xor_encode": 0, "xor_gather": 1}
    build._LIBS.clear()                            # a path that drops them
    with pytest.raises(guard.RecompileError):
        with guard.recompile_guard("stream"):
            (build.CSRC / "xor_encode.cu").write_text("// edited\n")
            build.library("xor_encode")


def test_unknown_target_raises_key_error(nvcc):
    with pytest.raises(KeyError):
        guard.resolve("no_such_entry_point")
    with pytest.raises(KeyError):
        with guard.recompile_guard("no_such_entry_point"):
            pass


def test_targets_are_jax_names_over_the_port_libraries():
    """The port guards JAX's target names; each names a library of
    ``csrc/``; ``sweep`` and ``stream`` name the two simulator kernels."""
    assert set(guard.GUARDED) == set(jguard.GUARDED)
    sources = {f.stem for f in build.CSRC.glob("*.cu")}
    for name in guard.GUARDED:
        assert set(guard.resolve(name)) <= sources, name
        assert guard.available(name)
    assert guard.resolve("sweep") == guard.resolve("stream") == (
        "xor_gather", "xor_encode")
    assert guard.resolve("kernels.pool_gather") == ("gather_pool",)
