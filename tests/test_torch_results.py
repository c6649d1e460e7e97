"""The port's results store and the paths that run through it on the CPU,
against the JAX package: ``run_sweep`` rows value for value (with and
without baseline columns), ``to_json`` rows and ``to_csv`` text byte for
byte, the ambiguous-baseline error, ``by``/``one``; the ``ramulator``
wrappers (``sweep_point``, ``sweep_alpha`` with α below r,
``compare_schemes``) against JAX's and the port's looped ``simulate``; the
Fig 18 harness against JAX's ``benchmarks/fig18_dedup.run`` row for row,
and the quickstart.

Small geometry (``tests/conftest.py``: 64 rows x 32 requests a core,
r = 0.125); inputs are seeded numpy handed to both sides. Each JAX batch
compiles for a few seconds, so the JAX sweeps here are of one or two
schemes where a test needs no more."""
import dataclasses
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.system import SimResult as JSimResult
from repro.sim import ramulator as jram
from repro.sim import trace as jtrace
from repro.sweep import engine as jeng
from repro.sweep import results as jres
from repro_torch.core.system import SimResult
from repro_torch.harness import common
from repro_torch.sim import ramulator
from repro_torch.sim import trace as ttrace
from repro_torch.sweep import engine, results
from test_torch_sweep import _tpt

jgrid = importlib.import_module("repro.sweep.grid")
tgrid = importlib.import_module("repro_torch.sweep.grid")
CPU = "cpu"
SMALL = dict(scheme="scheme_i", n_rows=64, length=32, n_cores=4, n_banks=8,
             alpha=0.25, r=0.125, select_period=16)
SPEC = dict(n_cores=4, length=32, n_banks=8, n_rows=64, write_frac=0.3,
            seed=1)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """JAX compiles this module's programs at XLA's backend optimization
    level 0 (``jax_disable_most_optimizations``; the simulator is integer
    arithmetic, so the rows do not depend on it) and torch runs on one
    intra-op thread, as in ``tests/test_torch_paper_tables.py``: a worker
    of the 6-worker run died inside the Fig 18 case's JAX compiles. Both
    settings are restored after the module's tests."""
    saved = (jax.config.read("jax_disable_most_optimizations"),
             torch.get_num_threads())
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_disable_most_optimizations", saved[0])
    torch.set_num_threads(saved[1])


def _sweep_points():
    """Two batches: the uncoded baseline and scheme_ii at two α, each at
    two seeds (so every coded row has a workload-matched baseline)."""
    base = jgrid.SweepPoint(**SMALL)
    return (jgrid.grid(base.replace(scheme="uncoded", alpha=1.0),
                       seed=(0, 1))
            + jgrid.grid(base.replace(scheme="scheme_ii"), alpha=(0.25, 0.5),
                         seed=(0, 1)))


@pytest.fixture(scope="module")
def swept():
    """JAX's and the port's ``run_sweep`` of the same points."""
    jpts = _sweep_points()
    return (jeng.run_sweep(jpts),
            engine.run_sweep([_tpt(p) for p in jpts], device=CPU))


def test_run_sweep_rows_match_jax(swept):
    """Rows equal value for value (python types included), with the
    baseline columns and without them."""
    jrs, trs = swept
    assert len(trs) == len(jrs) == 6
    for kw in ({}, {"baseline": None}):
        want, got = jrs.rows(**kw), trs.rows(**kw)
        assert got == want
        for w, g in zip(want, got):
            assert list(g) == list(w)
            assert [type(v) for v in g.values()] == [type(v)
                                                     for v in w.values()]
    rows = trs.rows()
    assert all("speedup" in r for r in rows)
    assert "speedup" not in trs.rows(baseline=None)[0]
    assert list(results.POINT_COLS) == list(jres.POINT_COLS)
    assert list(results.RESULT_COLS) == list(jres.RESULT_COLS)
    assert results.BASELINE_COLS == jres.BASELINE_COLS
    assert results.DEFAULT_MATCH == jres.DEFAULT_MATCH


def test_export_is_byte_equal_to_jax(swept, tmp_path):
    """``to_json`` and ``to_csv`` write JAX's bytes for the same meta."""
    jrs, trs = swept
    meta = {"r": 0.125, "length": 32, "note": "small"}
    for kw in ({}, {"baseline": None}):
        tag = "base" if not kw else "plain"
        jj = jrs.to_json(str(tmp_path / "jax" / f"{tag}.json"), meta, **kw)
        tj = trs.to_json(str(tmp_path / "port" / f"{tag}.json"), meta, **kw)
        assert open(tj, "rb").read() == open(jj, "rb").read()
        jc = jrs.to_csv(str(tmp_path / "jax" / f"{tag}.csv"), **kw)
        tc = trs.to_csv(str(tmp_path / "port" / f"{tag}.csv"), **kw)
        assert open(tc, "rb").read() == open(jc, "rb").read()
    blob = json.load(open(tmp_path / "port" / "base.json"))
    assert blob["meta"] == meta and len(blob["rows"]) == len(trs)


def test_lookups(swept):
    jrs, trs = swept
    assert len(trs.by(scheme="scheme_ii")) == 4
    assert len(trs.by(scheme="uncoded", seed=1)) == 1
    rec = trs.one(scheme="scheme_ii", alpha=0.5, seed=0)
    want = jrs.one(scheme="scheme_ii", alpha=0.5, seed=0)
    assert tuple(rec.result) == tuple(want.result)
    assert rec.point == _tpt(want.point)
    for coords in ({"scheme": "scheme_ii"}, {"scheme": "nope"}):
        with pytest.raises(KeyError) as te:
            trs.one(**coords)
        with pytest.raises(KeyError) as je:
            jrs.one(**coords)
        assert str(te.value) == str(je.value)


def _fake(cycles):
    return dict(cycles=cycles, completed=True, served_reads=10,
                served_writes=4, degraded_reads=1, parked_writes=0,
                switches=0, recode_backlog=0, stall_cycles=3,
                avg_read_latency=1.5, avg_write_latency=0.25)


def test_ambiguous_baseline_raises_as_jax():
    """Two baselines with different cycles under one match key raise
    JAX's error; a match that tells them apart normalizes each row."""
    kw = [dict(scheme="uncoded", select_period=8),
          dict(scheme="uncoded", select_period=64), dict()]
    cycles = (40, 44, 30)

    def store(mod, grid_mod, res_t):
        return mod.SweepResultSet([
            mod.SweepRecord(grid_mod.SweepPoint(**dict(SMALL, **k)),
                            res_t(**_fake(c))) for k, c in zip(kw, cycles)])

    jrs = store(jres, jgrid, JSimResult)
    trs = store(results, tgrid, SimResult)
    with pytest.raises(ValueError, match="ambiguous baseline") as te:
        trs.rows()
    with pytest.raises(ValueError) as je:
        jrs.rows()
    assert str(te.value) == str(je.value)
    match = ("trace", "seed", "length", "select_period")
    assert trs.rows(match=match) == jrs.rows(match=match)
    assert trs.rows(match=match)[0]["speedup"] == 1.0


# --------------------------------------------------------- ramulator
def _traces():
    spec = jtrace.TraceSpec(**SPEC)
    jtr = jtrace.banded_trace(spec)
    ttr = ttrace.banded_trace(ttrace.TraceSpec(**SPEC), device=CPU)
    for name in ttr._fields:
        np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                      np.asarray(getattr(jtr, name)))
    return jtr, ttr


def _looped(scheme, tr, alpha, r, **kw):
    return ramulator.simulate(scheme, tr, SPEC["n_rows"], alpha=alpha, r=r,
                              device=CPU, **kw)


def test_sweep_point_matches_jax():
    jtr, ttr = _traces()
    for kw in ({}, {"n_cycles": 77, "queue_depth": 6, "recode_budget": 2,
                    "select_period": 8, "wq_hi": 4, "wq_lo": 1}):
        want = jram.sweep_point("scheme_iii", jtr, 64, alpha=0.5, r=0.125,
                                **kw)
        got = ramulator.sweep_point("scheme_iii", ttr, 64, alpha=0.5,
                                    r=0.125, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_sweep_alpha_matches_jax_and_looped():
    """α below r (no parity slot), a partial one and full coverage: two
    batches, each point equal to JAX's and to the looped ``simulate``."""
    jtr, ttr = _traces()
    alphas = (0.0625, 0.25, 1.0)
    kw = dict(select_period=8)
    want = jram.sweep_alpha("scheme_ii", jtr, 64, alphas=alphas, r=0.125,
                            **kw)
    got = ramulator.sweep_alpha("scheme_ii", ttr, 64, alphas=alphas,
                                r=0.125, device=CPU, **kw)
    assert list(got) == list(want) == list(alphas)
    for a in alphas:
        assert tuple(got[a]) == tuple(want[a]), a
        assert got[a] == _looped("scheme_ii", ttr, a, 0.125, **kw), a
    assert got[1.0].switches == 0


def test_compare_schemes_matches_jax_and_looped():
    """``compare_schemes`` goes through ``run_points`` (one batch a
    scheme) and equals JAX's and the looped ``simulate``."""
    jtr, ttr = _traces()
    schemes = ("uncoded", "scheme_iii")
    kw = dict(n_cycles=300, select_period=8)
    want = jram.compare_schemes(jtr, 64, alpha=0.5, r=0.125,
                                schemes=schemes, **kw)
    got = ramulator.compare_schemes(ttr, 64, alpha=0.5, r=0.125,
                                    schemes=schemes, device=CPU, **kw)
    assert list(got) == list(want) == list(schemes)
    for s in schemes:
        assert tuple(got[s]) == tuple(want[s]), s
        assert got[s] == _looped(s, ttr, 0.5, 0.125, **kw), s


def test_compare_schemes_runs_batched(monkeypatch):
    """``compare_schemes`` makes one ``run_points`` call, not one looped
    run a scheme."""
    _, ttr = _traces()
    calls = []
    real = engine.run_points

    def spy(points, *a, **kw):
        calls.append(len(points))
        return real(points, *a, **kw)

    monkeypatch.setattr(engine, "run_points", spy)
    monkeypatch.setattr(ramulator, "simulate", None)     # never looped
    ramulator.compare_schemes(ttr, 64, alpha=1.0, r=0.25, n_cycles=64,
                              device=CPU)
    assert calls == [4]


# ----------------------------------------------------------- harnesses
def test_fig18_harness_matches_jax(monkeypatch, tmp_path, capsys):
    """The port's Fig 18 harness on the CPU gives JAX's
    ``benchmarks/fig18_dedup.run`` rows at the small geometry, prints
    JAX's table, and writes its artefact (with a CPU manifest) only under
    its artefact directory."""
    import benchmarks.fig18_dedup as jfig
    from repro_torch.harness import fig18_dedup

    monkeypatch.setattr(jfig, "emit", lambda *a, **k: None)
    kw = dict(length=32, n_rows=64, r=0.125)
    want = jfig.run(**kw)
    jout = capsys.readouterr().out
    monkeypatch.setattr(common, "ART_DIR", str(tmp_path))
    got = fig18_dedup.run(device=CPU, **kw)
    tout = capsys.readouterr().out
    assert got == want and len(got) == 16
    assert [[type(v) for v in r.values()] for r in got] == [
        [type(v) for v in r.values()] for r in want]
    assert tout.startswith(jout)
    assert "16 points in 7 batches" in tout
    assert tout.count("batched cycles against drain_bound") == 7
    blob = json.load(open(tmp_path / "fig18_dedup.json"))
    assert blob["rows"] == json.loads(json.dumps(want))
    assert blob["manifest"]["devices"]["backend"] in ("cpu", "cuda")
    assert len(blob["meta"]["batches"]) == 7
    assert os.listdir(tmp_path) == ["fig18_dedup.json"]
    assert all(r["switches"] == 0 for r in got if r["alpha"] == 1.0)


def test_quickstart_on_the_cpu(capsys):
    """The quickstart's four schemes through ``compare_schemes`` equal the
    looped ``simulate``; scheme I beats uncoded, as it asserts."""
    from repro_torch.harness import quickstart

    res = quickstart.main(device=CPU)
    assert list(res) == ["uncoded", "scheme_i", "scheme_ii", "scheme_iii"]
    assert res["scheme_i"].cycles < res["uncoded"].cycles
    tr = ttrace.banded_trace(ttrace.TraceSpec(
        n_cores=8, length=64, n_banks=8, n_rows=256, write_frac=0.3, seed=0),
        device=CPU)
    for s in ("uncoded", "scheme_i"):
        assert res[s] == ramulator.simulate(s, tr, 256, alpha=1.0, r=0.25,
                                            n_cycles=512, device=CPU), s
    assert "fewer memory cycles" in capsys.readouterr().out


def test_harness_table_matches_jax():
    import benchmarks.common as jcommon

    rows = [{"a": 1, "b": 0.123456, "c": None, "d": 1e6, "e": 0.0},
            {"a": "x", "b": 2e-4, "c": True, "d": -3.5, "e": 12}]
    assert common.table(rows, list("abcde")) == jcommon.table(rows,
                                                              list("abcde"))
    assert common.table([], ["a"]) == jcommon.table([], ["a"])


def test_emit_writes_only_its_artefact(monkeypatch, tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    monkeypatch.setattr(common, "REPO_ROOT", str(root))
    monkeypatch.setattr(common, "ART_DIR", str(root / "experiments"
                                               / "torch"))
    path = common.emit("BENCH_x", [{"a": np.float32(1.5)}], {"m": 1},
                       headline={"h": 2}, timings={"t": 0.5})
    assert path == str(root / "experiments" / "torch" / "BENCH_x.json")
    assert os.listdir(root) == ["experiments"]
    blob = json.load(open(path))
    assert blob["rows"] == [{"a": 1.5}] and blob["headline"] == {"h": 2}
    assert blob["manifest"]["timings"] == {"t": 0.5}

