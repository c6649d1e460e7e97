"""The port's workload suites, paper constants, package exports and run
manifests (``repro_torch.sweep.workloads``, ``repro_torch.configs.
paper_memsys``, ``repro_torch.{core,sim,sweep}``, ``repro_torch.obs.
runlog``) on the CPU against the JAX package: every suite's point list
field by field, ``suite()`` stamping, file-sized points over the
``tests/data`` fixtures, the suites' errors, the exported names (each name
the port leaves out listed with its reason) and the manifest blocks.

Suites are pure point lists: nothing here runs a simulation."""
import ast
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from repro.configs import paper_memsys as jmemsys
from repro.obs import runlog as jrunlog
from repro.sweep import workloads as jwork
from repro_torch.configs import paper_memsys
from repro_torch.obs import runlog
from repro_torch.sweep import workloads
from test_torch_sweep import _error

jgrid = importlib.import_module("repro.sweep.grid")
tgrid = importlib.import_module("repro_torch.sweep.grid")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SCEN_DIR = os.path.join(DATA, "scenarios")
# tests/conftest.py's small geometry: 64 rows x 32 requests a core
SMALL = dict(scheme="scheme_i", n_rows=64, length=32, n_cores=4, n_banks=8,
             alpha=0.25, r=0.125, select_period=16)


def _points(pts):
    return [dataclasses.asdict(p) for p in pts]


# -------------------------------------------------------------- constants
def test_paper_memsys_matches_jax():
    assert paper_memsys.PAPER_ALPHAS == jmemsys.PAPER_ALPHAS
    assert paper_memsys.PAPER_SCHEMES == jmemsys.PAPER_SCHEMES
    assert (dataclasses.asdict(paper_memsys.MemSysConfig())
            == dataclasses.asdict(jmemsys.MemSysConfig()))


def test_sweep_point_defaults_match_jax():
    """Suites start from ``SweepPoint()``: both defaults must agree."""
    assert _points([tgrid.SweepPoint()]) == _points([jgrid.SweepPoint()])


# ----------------------------------------------------------------- suites
SUITE_CASES = {
    "trace_zoo": {},
    "trace_zoo_small": {"seeds": (3,), "traces": ("zipf", "banded")},
    "multi_seed": {"n_seeds": 3},
    "tunable_grid": {"select_periods": (8, 16), "wq_his": (4,)},
    "paper_fig18": {},
    "paper_fig18_r": {"schemes": ("scheme_iii",), "alphas": (0.0625, 1.0),
                      "r": 0.125},
    "paper_fig19": {},
    "paper_fig19_bands": {"rs": (0.125,), "alphas": (0.5,), "n_bands": 4},
    "paper_fig20": {},
    "paper_fig20_drift": {"drifts": (0.5,), "alphas": (1.0,)},
    "scenario_pack": {"directory": SCEN_DIR},
    "scenario_pack_alphas": {"directory": SCEN_DIR, "line_bytes": 1,
                             "alphas": (0.25, 0.5)},
}


@pytest.mark.parametrize("base", ["default", "small"])
@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_suite_points_match_jax(case, base):
    """Each suite, through ``suite()`` (stamped with its name) and called
    directly, gives JAX's points field by field."""
    name = next(n for n in sorted(workloads.SUITES, key=len, reverse=True)
                if case.startswith(n))
    kw = SUITE_CASES[case]
    bases = {"default": (jgrid.SweepPoint(), tgrid.SweepPoint()),
             "small": (jgrid.SweepPoint(**SMALL), tgrid.SweepPoint(**SMALL))}
    jb, tb = bases[base]
    want = jwork.suite(name, jb, **kw)
    got = workloads.suite(name, tb, **kw)
    assert got and _points(got) == _points(want)
    assert all(p.suite == name for p in got)
    assert (_points(workloads.SUITES[name](tb, **kw))
            == _points(jwork.SUITES[name](jb, **kw)))


def test_suite_registry_matches_jax():
    assert sorted(workloads.SUITES) == sorted(jwork.SUITES)
    assert workloads.SCENARIO_EXTENSIONS == jwork.SCENARIO_EXTENSIONS


@pytest.mark.parametrize("drift", [0.0, 0.25, 1.0, 2])
def test_drift_label_matches_jax(drift):
    assert workloads.drift_label(drift) == jwork.drift_label(drift)


FILE_CASES = {
    "npz": ("file_point", "tiny_trace.npz", {}),
    "npz_kw": ("file_point", "tiny_trace.npz", {"alpha": 0.5, "label": "x"}),
    "ramulator": ("text_file_point", "tiny_ramulator.trace", {}),
    "ramulator_lb": ("text_file_point", "tiny_ramulator.trace",
                     {"line_bytes": 64, "seed": 2}),
    "gem5_format": ("text_file_point", "tiny_gem5.gem5",
                    {"format": "gem5", "line_bytes": 8}),
}


@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_file_points_match_jax_and_build(case):
    """``file_point``/``text_file_point`` size a point to its file as JAX
    does, and the point's trace builds at that geometry with JAX's
    streams."""
    fn, fname, kw = FILE_CASES[case]
    path = os.path.join(DATA, fname)
    base_kw = dict(SMALL, n_cores=2)
    want = getattr(jwork, fn)(path, jgrid.SweepPoint(**base_kw), **kw)
    got = getattr(workloads, fn)(path, tgrid.SweepPoint(**base_kw), **kw)
    assert _points([got]) == _points([want])
    jtr = jwork.build_trace(want)
    ttr = workloads.build_trace(got, device="cpu")
    for name in ttr._fields:
        np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                      np.asarray(getattr(jtr, name)),
                                      err_msg=f"{case}: {name}")


def test_scenario_pack_traces_match_jax():
    """Every point of the checked-in scenario pack builds JAX's trace."""
    base = dict(SMALL, r=0.05, recode_cap=16)
    want = jwork.suite("scenario_pack", jgrid.SweepPoint(**base),
                       directory=SCEN_DIR)
    got = workloads.suite("scenario_pack", tgrid.SweepPoint(**base),
                          directory=SCEN_DIR)
    assert len(got) == len(os.listdir(SCEN_DIR))
    for jp, tp in zip(want, got):
        jtr, ttr = jwork.build_trace(jp), workloads.build_trace(tp,
                                                                device="cpu")
        for name in ttr._fields:
            np.testing.assert_array_equal(getattr(ttr, name).numpy(),
                                          np.asarray(getattr(jtr, name)),
                                          err_msg=f"{tp.label}: {name}")


def test_suite_errors_match_jax(tmp_path):
    """An unknown suite, a scenario pack without a directory, with a
    missing one and with one that holds no trace file raise JAX's
    exception types with JAX's messages."""
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("not a trace")
    cases = [
        ("nope", {}),
        ("scenario_pack", {}),
        ("scenario_pack", {"directory": str(tmp_path / "missing")}),
        ("scenario_pack", {"directory": str(empty)}),
    ]
    for name, kw in cases:
        want = _error(lambda: jwork.suite(name, jgrid.SweepPoint(), **kw))
        got = _error(lambda: workloads.suite(name, tgrid.SweepPoint(), **kw))
        assert got == want, (name, kw)


# ---------------------------------------------------------------- exports
# Names of the JAX package's public surface the port leaves out, and why.
ABSENT = {
    "repro.core": {
        "wide_add": "the port's wide counters are native int64 tensors "
                    "(no (lo, hi) uint32 pairs to carry)",
        "wide_zero": "as wide_add: an int64 zero needs no helper",
        "wide_total": "as wide_add: an int64 counter is its own total "
                      "(tests compare through repro_torch.convert)",
    },
    "repro.sim": {},
    "repro.sweep": {},
}


def _exported(path):
    """The names a package ``__init__`` imports from its modules."""
    tree = ast.parse(open(path).read())
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom)
                  for a in node.names)


@pytest.mark.parametrize("pkg", sorted(ABSENT))
def test_package_exports_match_jax(pkg):
    """The port's ``core``, ``sim`` and ``sweep`` packages export JAX's
    public names, each missing one listed in ``ABSENT`` with its reason,
    and none listed there is exported after all."""
    path = os.path.join(ROOT, "src", *pkg.split("."), "__init__.py")
    names = _exported(path)
    assert names
    port = importlib.import_module(pkg.replace("repro", "repro_torch", 1))
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == sorted(ABSENT[pkg])
    assert all(hasattr(importlib.import_module(pkg), n) for n in names)


def test_sim_exports_the_drivers():
    from repro_torch.sim import compare_schemes, simulate, sweep_alpha
    from repro_torch.sim import ramulator
    assert (simulate, compare_schemes, sweep_alpha) == (
        ramulator.simulate, ramulator.compare_schemes, ramulator.sweep_alpha)


def test_core_exports_resolve_to_the_modules():
    """``repro_torch.core``'s names are the modules' own objects (the
    system's load on first use)."""
    import repro_torch.core as core
    from repro_torch.core import codes, controller, state, system
    assert core.CodedMemorySystem is system.CodedMemorySystem
    assert core.SimResult is system.SimResult and core.Trace is system.Trace
    assert core.get_tables is codes.get_tables
    assert core.build_read_pattern is controller.build_read_pattern
    assert core.make_params is state.make_params
    with pytest.raises(AttributeError):
        core.not_a_name


# --------------------------------------------------------------- manifests
def test_point_config_matches_jax():
    """A point's manifest block: its coordinates and the engine's batch
    key, as JAX's (the port's ``static_signature`` equals JAX's)."""
    for kw in (SMALL, dict(SMALL, alpha=1.0, scheme="uncoded")):
        assert (runlog.point_config(tgrid.SweepPoint(**kw))
                == jrunlog.point_config(jgrid.SweepPoint(**kw)))


def test_run_manifest_on_the_cpu(tmp_path, monkeypatch):
    """On a machine without a card the manifest says so; it names torch,
    numpy and python, the commit, the config and the timings."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    man = runlog.run_manifest(config=tgrid.SweepPoint(**SMALL),
                              timings={"grid_s": 1.23456789},
                              extra={"note": "x"})
    assert man["schema"] == runlog.MANIFEST_SCHEMA == jrunlog.MANIFEST_SCHEMA
    assert man["devices"]["backend"] == "cpu"
    assert man["devices"]["n_devices"] == 0 and man["devices"]["cards"] == []
    assert set(man["versions"]) == {"python", "torch", "numpy"}
    assert man["versions"]["torch"] == torch.__version__
    assert man["git_sha"] == jrunlog.git_sha()
    assert man["config"]["static_signature"]
    assert man["timings"] == {"grid_s": 1.2346} and man["note"] == "x"
    path = runlog.write_manifest(str(tmp_path / "m" / "manifest.json"),
                                 config={"k": 1})
    assert os.path.exists(path)


def test_card_lines_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(runlog, "NVIDIA_SMI", ["/nonexistent/nvidia-smi"])
    assert runlog.card_lines() == []
