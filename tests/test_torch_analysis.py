"""The port's static analysis (``repro_torch.analysis``) on the CPU: the
GF(2) certificates equal the JAX package's (live and saved, scheme by
scheme), both verifiers give the same rule ids on the same mutated
tables, each repo rule flags its fixture (written under ``tmp_path``)
and is clean on ``src/repro_torch``, the carry lint flags injected
drifts and is clean on the real cycle and serve step, and the CLI's
``--strict --device cpu`` run exits 0 (mirrors ``tests/test_analysis.py``;
no JAX program is compiled here)."""
import json
import os
import shutil

import pytest
import torch

from repro.analysis import schemes as jschemes
from repro_torch.analysis import carry, rules, schemes
from repro_torch.analysis.__main__ import main
from repro_torch.sweep import SweepPoint, engine

DATA = os.path.join(os.path.dirname(__file__), "data", "analysis")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(findings):
    return sorted(f.rule for f in findings)


def _plain(findings):
    return sorted((f.rule, f.location) for f in findings)


# ------------------------------------------------------ scheme certificates
def test_certify_equals_jax_live_and_saved():
    """``certify()`` equals JAX's ``certify()`` and JAX's checked-in
    ``certificates.json``, scheme by scheme; the port's own document has
    the same content; the layer is clean."""
    mine, theirs = schemes.certify(), jschemes.certify()
    saved = jschemes.load_certificates()
    assert sorted(mine["schemes"]) == sorted(saved["schemes"])
    for name in saved["schemes"]:
        assert mine["schemes"][name] == theirs["schemes"][name], name
        assert mine["schemes"][name] == saved["schemes"][name], name
    assert {k: v for k, v in mine.items() if k != "schemes"} == {
        k: v for k, v in saved.items() if k != "schemes"}
    assert schemes.load_certificates() == saved
    assert schemes.DECLARED == jschemes.DECLARED
    assert schemes.run() == []


def test_pool_layout_is_the_servers():
    """The certified pool tables are the port's ``parity_members``, and
    ``pool_init`` sizes its parity groups from them."""
    from repro.runtime.kvbank import parity_members as jmembers
    from repro_torch.runtime import kvbank as kb

    assert kb.parity_members(8) == jmembers(8)
    assert schemes.pool_tables() == jschemes.pool_tables()
    pool = kb.pool_init(kb.KVBankConfig(n_banks=8, page=2, pool_pages=16,
                                        max_pages=2), 1, 1, 1, 4,
                        torch.float32, device=CPU)
    assert pool.k_par.shape[1] == len(kb.parity_members(8)[0])


def _bad_scheme():
    with open(os.path.join(DATA, "bad_scheme.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("case", ["under-tolerant", "undeclared",
                                  "serving-unsound", "wrong-parent",
                                  "stale-document"])
def test_mutated_tables_give_jaxs_rule_ids(case, tmp_path):
    """The same mutation through both verifiers: the same rule ids at the
    same locations."""
    def both(fn):
        return [fn(mod) for mod in (schemes, jschemes)]

    if case == "under-tolerant":
        spec = _bad_scheme()

        def fn(mod):
            entry = mod.analyze_scheme(
                spec["name"], members=[tuple(m) for m in spec["members"]],
                phys=spec["phys"], n_data=spec["n_data"])
            return mod.verify_scheme_claims(spec["name"], entry,
                                            declared=spec["declared"])
    elif case == "undeclared":
        def fn(mod):
            return mod.verify_scheme_claims("not_a_declared_scheme",
                                            mod.analyze_scheme("scheme_i"))
    elif case == "serving-unsound":
        def fn(mod):
            entry = mod.analyze_scheme("scheme_i")
            entry["serving_tolerance"]["1"] = (
                entry["serving_tolerance"]["1"] + [[0]])
            return mod.verify_scheme_claims("scheme_i", entry)
    elif case == "wrong-parent":
        def fn(mod):
            return mod.check_pool_subcode(parent="uncoded")
    else:
        path = str(tmp_path / "certificates.json")
        shutil.copy(schemes.CERT_PATH, path)
        with open(path) as fh:
            doc = json.load(fh)
        doc["schemes"]["scheme_i"]["locality"] = 5
        doc["schemes"]["gone"] = doc["schemes"].pop("replication_4")
        with open(path, "w") as fh:
            json.dump(doc, fh)

        def fn(mod):
            return mod.verify_certificates(path)
    mine, theirs = both(fn)
    assert mine and _plain(mine) == _plain(theirs)
    want = {"under-tolerant": {"scheme-under-tolerant"},
            "undeclared": {"scheme-undeclared"},
            "serving-unsound": {"scheme-serving-unsound"},
            "wrong-parent": {"pool-subcode"},
            "stale-document": {"scheme-cert-stale"}}[case]
    assert set(_ids(mine)) == want


def test_table_hash_and_diff_equal_jaxs():
    for name in sorted(schemes.certify()["schemes"]):
        if name == "kv_pool":
            continue
        members, phys, _ = schemes._scheme_tables(name)
        assert schemes.table_hash(members, phys) == jschemes.table_hash(
            members, phys)
    members, phys, _ = schemes._scheme_tables("scheme_ii")
    bent = [tuple(reversed(m)) for m in members[:-1]] + [(0, 7)]
    assert schemes.diff_tables("scheme_ii", members, phys, bent,
                               phys[::-1]) == jschemes.diff_tables(
        "scheme_ii", members, phys, bent, phys[::-1])
    assert schemes.check_stride_grid() == [] == jschemes.check_stride_grid()
    assert not schemes.stride_alias_free(2, 3, 2, 8)


# --------------------------------------------------------------- repo rules
def _write(tmp_path, name, text):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return str(path)


def test_oracle_purity_flags_fixture(tmp_path):
    _write(tmp_path, "oracle/model.py",
           "import numpy as np\nimport torch\n"
           "from repro_torch.core import codes\n"
           "from repro_torch.oracle import kvpool\nimport itertools\n")
    fs = rules.check_oracle_purity(root=str(tmp_path / "oracle"))
    assert _ids(fs) == ["oracle-purity"] * 2
    assert {f.message.split("'")[1] for f in fs} == {"torch",
                                                     "repro_torch.core"}
    assert rules.check_oracle_purity() == []


def test_port_isolation_flags_fixture(tmp_path):
    path = _write(tmp_path, "mod.py",
                  "import jax\nimport jaxlib.xla_client\n"
                  "from repro.core import codes\nimport repro_torch\n"
                  "from repro_torch import axes\n")
    fs = rules.check_port_isolation([path])
    assert [f.line for f in fs] == [1, 2, 3]
    assert set(_ids(fs)) == {"port-isolation"}
    assert rules.check_port_isolation() == []


DEVICE_FIXTURE = '''\
import torch


def host_reads(x, t):
    if x.any():
        pass
    n = int(x.sum())
    y = x.tolist()
    z = x.item()
    k = torch.nonzero(x)
    w = 1 if x.max() > 0 else 2
    while x.any():
        break
    # analysis: host-sync
    v = x.cpu()
    return n, y, z, k, w, v


def static_geometry(p, i):
    a = i // p.region_size
    b = i % p.n_slots
    rs = p.region_size
    c = i // rs
    rs2 = rs_active if rs_active is not None else p.region_size
    d = i % rs2
    return a, b, c, d, i * p.region_size


def narrow_counters(m, x):
    m = m._replace(stall_cycles=m.stall_cycles + x.int())
    m.read_latency_sum = torch.zeros(1, dtype=torch.int32)
    return m._replace(write_latency_sum=m.write_latency_sum + x)


def clean(p, x, n: int, t=None):
    if p.telemetry and t is None:
        pass
    if x.shape[0] > 1 and x.dim() == 2 and x.numel() and len(x):
        pass
    host = x.tolist()  # analysis: host-sync the fixture's one read
    if any(h > 0 for h in host) and n > 2 and isinstance(x, torch.Tensor):
        pass
    # analysis: host-sync a waiver above a statement covers all its lines
    k = (x.sum()
         .item())
    for b in range(n):
        if b % 2 and host[b]:
            pass
    return k


def unclassified():
    return 0


class Unit:
    def step(self, x):
        if self.p.faults:
            return x.tolist()
        return x
'''


def test_device_rules_flag_fixture(tmp_path):
    path = _write(tmp_path, "core/fixture.py", DEVICE_FIXTURE)
    fs = rules.check_device_rules(
        [path], device={"host_reads", "static_geometry", "narrow_counters",
                        "clean", "Unit.*"},
        host={"unclassified"}, geometry=True)
    by = {}
    for f in fs:
        by.setdefault(f.rule, []).append(f)
    assert set(by) == {"host-sync", "static-geometry", "narrow-counter",
                       "waiver-reason"}
    hs = by["host-sync"]
    # if, int(), .tolist(), .item(), nonzero, IfExp, while, and .cpu()
    # whose waiver names no reason; Unit.step's .tolist()
    assert sorted(f.line for f in hs) == [5, 7, 8, 9, 10, 11, 12, 15, 59]
    assert not any("'clean'" in f.message for f in fs)
    assert [f.line for f in by["waiver-reason"]] == [14]
    assert sorted(f.line for f in by["static-geometry"]) == [20, 21, 23]
    assert sorted(f.line for f in by["narrow-counter"]) == [30, 31]
    # classification: a function in neither map, or in both
    fs = rules.check_device_rules([path], device={"host_reads"},
                                  host={"host_reads", "clean"})
    unlisted = sorted(f.message.split("'")[1] for f in fs
                      if f.rule == "rule-classification")
    assert unlisted == ["Unit.step", "host_reads", "narrow_counters",
                        "static_geometry", "unclassified"]


def test_device_rules_clean_on_the_port():
    """The port's cycle surface: every function classified, every host
    read waived with its reason (the inventory), the allocated geometry
    never divided by, the wide counters int64."""
    assert rules.check_device_rules() == []
    waived = [line for path in rules._scope_files(rules.DEVICE_SCOPE)
              for line in open(path).read().splitlines()
              if "# analysis: host-sync" in line]
    assert len(waived) >= 10


FALLBACK_FIXTURE = '''\
import torch


def launch(x):
    try:
        return gather_cuda(x)
    except RuntimeError:
        return gather_plain(x)


def pick():
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    if torch.cuda.is_available():
        return dev
    else:
        return torch.device("cpu")


def fine(x):
    try:
        return gather_cuda(x)
    except RuntimeError as e:
        raise ValueError("the kernel failed") from e
'''


def test_no_fallback_flags_fixture(tmp_path):
    path = _write(tmp_path, "kernels/fixture.py", FALLBACK_FIXTURE)
    fs = rules.check_no_fallback([path])
    assert _ids(fs) == ["no-fallback"] * 3
    assert sorted(f.line for f in fs) == [5, 12, 15]
    assert rules.check_no_fallback() == []


def test_rules_layer_clean():
    assert rules.run() == []


# ---------------------------------------------------------------- carry lint
def _state(telemetry=False):
    pt = SweepPoint(n_rows=32, length=8, alpha=0.5, r=0.25,
                    telemetry=telemetry)
    sys_ = engine.system_for(pt, device=CPU)
    return carry._inputs(sys_, [pt, pt.replace(seed=1)], CPU)


@pytest.mark.parametrize("drift", ["int64", "device", "tele-appears"])
def test_carry_lint_flags_injected_drift(drift):
    """A step that promotes a leaf to int64, moves one to another device
    or grows a ``tele`` leaf under the flag off is flagged; the real
    cycle is not."""
    st, trace, tn = _state()
    on, _, _ = _state(telemetry=True)

    def step(s, *args):
        m = s.mem
        if drift == "int64":
            m = m._replace(cycle=m.cycle.long())
        elif drift == "device":
            return s._replace(core_ptr=s.core_ptr.to("meta"))
        else:
            m = m._replace(tele=on.mem.tele)
        return s._replace(mem=m)

    fs = carry.lint_carry("fixture", step, st, trace, tn, pick=lambda o: o)
    assert _ids(fs) == ["carry-drift"]
    assert {"int64": "int64", "device": "meta",
            "tele-appears": "Telemetry"}[drift] in fs[0].message
    sys_ = engine.system_for(SweepPoint(n_rows=32, length=8, alpha=0.5,
                                        r=0.25), device=CPU)
    assert carry.lint_carry("cycle", sys_.cycle_batch, st, trace, tn) == []


def test_carry_lint_flags_a_signature_leak(monkeypatch):
    """A static coordinate leaking out of the class key (a point's seed
    baked into its params) is flagged; the default grid is clean."""
    pts = carry.default_lint_points()
    assert carry.lint_signature_classes(pts, CPU) == []
    real = engine.params_for
    monkeypatch.setattr(engine, "params_for", lambda pt, *a, **k: real(
        pt, *a, **k)._replace(queue_depth=8 + pt.seed))
    fs = carry.lint_signature_classes(pts[:4], CPU)
    assert fs and set(_ids(fs)) == {"carry-static-leak"}


def test_op_sequences_tell_programs_apart():
    x = torch.arange(4)
    assert carry.op_sequence(lambda t: t + 1, x) == carry.op_sequence(
        lambda t: t + 2, x)
    assert carry.op_sequence(lambda t: t * 2, x) != carry.op_sequence(
        lambda t: t + 2, x)


@pytest.mark.parametrize("lint", ["carry_stability", "flag_identity",
                                  "serve_step"])
def test_carry_layer_clean_on_the_port(lint):
    assert getattr(carry, f"lint_{lint}")(CPU) == []


def test_cli_strict_on_the_cpu(capsys):
    assert main(["--strict", "--device", CPU]) == 0
    assert "analysis clean (schemes, carry, rules)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--layers", "jaxpr"])
