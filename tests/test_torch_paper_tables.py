"""The port's paper harnesses (``repro_torch.harness``) on the CPU against
the JAX package's: Fig 19, Fig 20, the §III-B scheme table and the
availability gate give JAX's rows and print JAX's tables at a reduced
geometry (JAX's ``emit`` stubbed, the port's artefacts under a temporary
directory); the gate exits nonzero on a violating row; the runner calls
every harness it names and names what the JAX runner runs beside them."""
import ast
import json
import os

import jax
import pytest
import torch

from repro_torch.harness import common

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """JAX compiles the harnesses' programs at XLA's backend optimization
    level 0 (``jax_disable_most_optimizations``; the simulator is integer
    arithmetic, so the rows do not depend on it) and torch runs on one
    intra-op thread, as in ``tests/test_torch_faults.py``: a worker of the
    6-worker run died of a segmentation fault inside XLA's optimizing
    compile of the scheme table's sweep. Both settings are restored after
    the module's tests."""
    saved = (jax.config.read("jax_disable_most_optimizations"),
             torch.get_num_threads())
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_disable_most_optimizations", saved[0])
    torch.set_num_threads(saved[1])


def _compare(monkeypatch, tmp_path, capsys, jmod, tmod, name, jkw=None):
    """Run the JAX harness and the port's with the same arguments: equal
    rows (values and types), JAX's printed output leading the port's, the
    port's artefact alone in its directory. Returns (rows, port output)."""
    monkeypatch.setattr(jmod, "emit", lambda *a, **k: None)
    want = jmod.run(**(jkw or {}))
    jout = capsys.readouterr().out
    monkeypatch.setattr(common, "ART_DIR", str(tmp_path))
    got = tmod.run(device=CPU, **(jkw or {}))
    tout = capsys.readouterr().out
    assert got == want and got
    assert [[type(v) for v in r.values()] for r in got] == [
        [type(v) for v in r.values()] for r in want]
    # JAX's printed lines, in order, among the port's (which add each
    # batch's cycles and the grid's wall time)
    lines = iter(tout.splitlines())
    for line in jout.splitlines():
        assert any(line == t for t in lines), line
    blob = json.load(open(tmp_path / f"{name}.json"))
    assert blob["rows"] == json.loads(json.dumps(want))
    assert blob["manifest"]["devices"]["backend"] in ("cpu", "cuda")
    assert os.listdir(tmp_path) == [f"{name}.json"]
    return got, tout


def test_fig19_harness_matches_jax(monkeypatch, tmp_path, capsys):
    import benchmarks.fig19_split as jfig
    from repro_torch.harness import fig19_split

    kw = dict(length=32, n_rows=64)
    rows, out = _compare(monkeypatch, tmp_path, capsys, jfig, fig19_split,
                         "fig19_split", kw)
    assert len(rows) == 13
    assert "13 points in 3 batches" in out
    assert out.count("batched cycles against drain_bound") == 3
    assert all(r["switches"] == 0 for r in rows if r["alpha"] == 1.0)


def test_fig20_harness_matches_jax(monkeypatch, tmp_path, capsys):
    import benchmarks.fig20_ramp as jfig
    from repro_torch.harness import fig20_ramp

    kw = dict(length=32, n_rows=64)
    rows, out = _compare(monkeypatch, tmp_path, capsys, jfig, fig20_ramp,
                         "fig20_ramp", kw)
    assert [r["trace"] for r in rows] == ["static"] * 2 + [
        "ramp_slow"] * 2 + ["ramp_fast"] * 2
    assert "9 points in 2 batches" in out
    # the paper's claim at this size: the gain shrinks as the bands drift
    red = [r["reduction_%"] for r in rows if r["alpha"] == 0.25]
    assert red[0] > red[1] > red[2]


def test_tab_schemes_matches_jax(monkeypatch, tmp_path, capsys):
    """The scheme table at its own (small) geometry: rates, locality,
    reads per bank, the §III-B best case through the batch-of-one read
    builder, and the uniform-trace cycles of all six schemes."""
    import benchmarks.tab_schemes as jtab
    from repro_torch.harness import tab_schemes

    rows, _ = _compare(monkeypatch, tmp_path, capsys, jtab, tab_schemes,
                       "tab_schemes")
    assert [r["scheme"] for r in rows] == list(tab_schemes.SCHEMES)
    best = {r["scheme"]: r["best_case_served"] for r in rows}
    assert best["scheme_i"] > 4 and best["uncoded"] is None


def test_fig_faults_matches_jax(monkeypatch, tmp_path, capsys):
    """The availability gate at ``--smoke`` geometry: JAX's rows, coded
    rows serving every read, uncoded rows not."""
    import benchmarks.fig_faults as jff
    from repro_torch.harness import fig_faults

    rows, out = _compare(monkeypatch, tmp_path, capsys, jff, fig_faults,
                         "fig_faults", dict(smoke=True))
    assert "availability gate OK" in out
    for r in rows:
        coded = r["scheme"] != "uncoded"
        assert (r["availability_%"] == 100.0) == coded, r
        assert (r["degraded_fault"] > 0) == coded, r
    for scheme in ("scheme_i", "scheme_iii", "uncoded"):
        assert fig_faults.dead_banks(scheme) == jff.dead_banks(scheme)


def test_fig_faults_gate_exits_on_a_violating_row(monkeypatch, tmp_path,
                                                  capsys):
    """At α = 0.1 (below r: nothing is coded) the coded schemes drop the
    dead banks' reads, so the gate fails: exit 1, naming each coded row."""
    from repro_torch.harness import fig_faults

    monkeypatch.setattr(common, "ART_DIR", str(tmp_path))
    monkeypatch.setattr(fig_faults, "ALPHA", 0.1)
    with pytest.raises(SystemExit) as e:
        fig_faults.run(smoke=True, device=CPU)
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "AVAILABILITY GATE FAILED" in out
    failed = [line for line in out.splitlines() if line.startswith("  - ")]
    assert len(failed) == 6 and all(
        "scheme_i" in line or "scheme_iii" in line for line in failed)


def test_runner_calls_every_harness(monkeypatch, capsys):
    """``harness.run --fast --device cpu`` calls each harness once with the
    fast arguments, and every name JAX's ``benchmarks/run.py`` imports is
    either run or named as not ported."""
    from repro_torch.harness import (fig18_dedup, fig19_split, fig20_ramp,
                                     fig_faults, quickstart, run,
                                     tab_schemes)

    calls = []

    def spy(name):
        return lambda **kw: calls.append((name, kw))

    for mod in (tab_schemes, fig18_dedup, fig19_split, fig20_ramp,
                fig_faults):
        monkeypatch.setattr(mod, "run", spy(mod.__name__.split(".")[-1]))
    monkeypatch.setattr(quickstart, "main",
                        lambda device=None: calls.append(
                            ("quickstart", {"device": device})))
    run.main(["--fast", "--device", CPU])
    assert calls == [
        ("tab_schemes", {"device": CPU}),
        ("fig18_dedup", {"length": 48, "device": CPU}),
        ("fig19_split", {"length": 48, "device": CPU}),
        ("fig20_ramp", {"length": 48, "device": CPU}),
        ("fig_faults", {"smoke": True, "device": CPU}),
        ("quickstart", {"device": CPU})]
    out = capsys.readouterr().out
    tree = ast.parse(open(os.path.join(ROOT, "benchmarks", "run.py")).read())
    jax_names = {a.name for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom)
                 and node.module == "benchmarks" for a in node.names}
    named = {n.strip() for names in run.NOT_PORTED for n in names.split(",")}
    ran = {name for name, _ in calls} - {"quickstart"}
    assert ran | named == jax_names and not ran & named
    for names in run.NOT_PORTED:
        assert names in out
