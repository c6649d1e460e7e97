"""The port's serving report against the JAX package's on the CPU: the
copied NumPy serving oracle (``repro_torch.oracle.kvpool``) equals
``repro.oracle.kvpool`` field for field on seeded page tables, lengths,
code-status tables and recode budgets; ``serve_report`` passes its
exact-equality gates (the code-status table against the oracle's replay
after every step, ``ServeSnapshot.check_against`` before rendering) and
its planes, totals and per-request token counts equal JAX's
``serve_report`` at ``--smoke``; the CLI's ``--serve`` writes the three
files.

The planes depend on the requests' lengths, the page placement (a seeded
permutation every 2 steps) and the recode budget, never on the weights:
the two packages draw different random weights from one seed, and the
planes still agree exactly. Times and the run manifest are left out of
the comparison."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.obs import report as jreport
from repro.oracle import kvpool as jkvpool
from repro_torch.obs import report as treport
from repro_torch.oracle import kvpool as tkvpool


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, n_banks, page, batch, max_pages):
    """A seeded pool step: distinct physical pages per sequence (some
    rows free), lengths up to the table's reach, a random code-status
    table and activity mask."""
    rng = np.random.default_rng(seed)
    slots = 2 * batch * max_pages // n_banks + 1
    perm = rng.permutation(n_banks * slots)[:batch * max_pages]
    table = perm.reshape(batch, max_pages).astype(np.int32)
    table[rng.random(batch) < 0.25] = -1
    length = rng.integers(0, page * max_pages, size=batch).astype(np.int32)
    length[table[:, 0] < 0] = 0
    fresh = rng.random((n_banks // 2, slots)) < 0.6
    active = (table[:, 0] >= 0) & (length > 0) & (rng.random(batch) < 0.9)
    return table, length, fresh, active


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [None, -1, 0, 3])
def test_oracle_copy_equals_jax(seed, budget):
    """``expected_step`` of both oracles on one seeded step (coded, and
    uncoded with no status table): every field bit-equal."""
    n_banks, page = (8, 4) if seed % 2 else (4, 16)
    case = _case(seed, n_banks, page, batch=5, max_pages=6)
    table, length, fresh, active = case
    for f in (fresh, None):
        want = jkvpool.expected_step(n_banks, page, table, length, f,
                                     active, budget)
        got = tkvpool.expected_step(n_banks, page, table, length, f,
                                    active, budget)
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if b is None:
                assert a is None, field.name
                continue
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
    assert tkvpool.lat_bin(0) == jkvpool.lat_bin(0) == 0
    assert all(tkvpool.lat_bin(v) == jkvpool.lat_bin(v)
               for v in (1, 2, 3, 7, 8, 1 << 20))


def _totals(t):
    return {f.name: np.asarray(getattr(t, f.name)).tolist()
            for f in dataclasses.fields(t)}


def _shape(out):
    """A report's result without times or the manifest: the planes, the
    oracle's totals and each request's slot, prompt length and tokens."""
    return {"planes": out["snapshot"].as_dict(),
            "totals": _totals(out["totals"]),
            "spans": [(s["rid"], s["slot"], s["prompt_len"], s["n_tokens"])
                      for s in out["spans"]],
            "counts": (out["summary"]["requests"],
                       out["summary"]["finished"],
                       out["summary"]["tokens"])}


@pytest.fixture(scope="module")
def jax_smoke(tmp_path_factory):
    return _shape(jreport.serve_report(
        out_dir=str(tmp_path_factory.mktemp("jax_serve")), smoke=True))


def test_serve_report_equals_jax(jax_smoke, tmp_path):
    """``serve_report(smoke=True)`` on the CPU: its gates pass and its
    planes, totals and lifecycle token counts equal JAX's."""
    out = treport.serve_report(out_dir=str(tmp_path), smoke=True,
                               device="cpu")
    got = _shape(out)
    assert got == jax_smoke
    assert got["planes"]["degraded_reads"] > 0, "no degraded read served"
    assert all(n == 6 for *_, n in got["spans"])


def test_drive_serve_with_oracle_refuses_a_diverged_table(tmp_path):
    """The per-step gate: a code-status table that leaves the replay
    (a fresh row marked stale behind the oracle's back) raises."""
    srv, reqs = treport.serve_setup(smoke=True, device="cpu")
    step = srv.step_decode

    def tampered():
        step()
        srv.cache["pool"].parity_fresh[0, 0] = False

    srv.step_decode = tampered
    with pytest.raises(AssertionError, match="oracle replay"):
        treport.drive_serve_with_oracle(srv, reqs)


def test_cli_serve_smoke_writes_three_files(tmp_path, capsys):
    assert treport.main(["--serve", "--smoke", "--device", "cpu",
                         "--out-dir", str(tmp_path)]) == 0
    assert "planes == oracle verified" in capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["serve_report.json", "serve_report.md",
                     "serve_trace.json"]
    blob = json.loads((tmp_path / "serve_report.json").read_text())
    assert set(blob) == {"manifest", "planes", "lifecycle", "trace_path"}
    assert "exact equality" in (tmp_path / "serve_report.md").read_text()
    trace = json.loads((tmp_path / "serve_trace.json").read_text())
    assert trace["traceEvents"]
