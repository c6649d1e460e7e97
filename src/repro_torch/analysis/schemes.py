"""Layer 1: the GF(2) scheme verifier of the port
(``repro.analysis.schemes`` counterpart, function for function).

Every scheme in ``repro_torch.core.codes.SCHEMES`` and the serving KV
pool's pairwise layout (``repro_torch.runtime.kvbank.parity_members``) is
admitted only through a *certificate* proved here from the scheme's
parity matrix itself (not from running the simulator). The port's
``certificates.json`` is its own file; its content equals the JAX
package's document, because both packages' tables are the same:

* **Erasure tolerance** — for k = 1, 2, every k-subset of data banks is
  classified as servable/unservable under the controller's single-decode
  serving rule (one parity option per read, all other members alive),
  re-derived here from the members matrix alone; and cross-checked against
  plain GF(2) rank analysis (a servable loss set MUST be information-
  theoretically recoverable — the serving rule can never beat linear
  algebra). ``DECLARED`` pins each scheme's claimed full-tolerance level;
  a scheme whose matrix doesn't deliver its claim fails verification.
* **Read degree** — each data row's serving options (1 direct + its parity
  options) and the *simultaneous* read capacity: the maximum set of
  pairwise port-disjoint recovery sets per row, proved by exhaustive
  subset search over the ≤ ``MAX_OPTS`` options (this is the paper's
  "reads per bank per cycle" §III-B claim).
* **Slot-stride aliasing** — under a padded sweep geometry, parity row
  addressing is ``slot * rs_alloc + (i mod rs_active)`` with
  ``rs_active ≤ rs_alloc``; distinct slots must never alias. Verified
  exhaustively over a geometry grid covering every padded combination the
  engine can build (offset < rs_active ≤ rs_alloc keeps each slot inside
  its own stride window — the check would catch any future indexing scheme
  that breaks this).
* **Table hash** — a canonical SHA-256 of the (members, phys) tables. The
  oracle's independently derived tables must hash identically; on
  divergence ``diff_tables`` names the scheme and the exact field (see
  tests/test_torch_analysis.py), instead of a bare assert.

``certify()`` emits the machine-readable certificate document;
``verify_certificates()`` recomputes it and diffs against the checked-in
``certificates.json`` (the CI gate: a scheme change without a matching
certificate regeneration fails). New schemes (e.g. the ROADMAP's LVT/ILVT
multi-write designs) are admitted by adding a ``DECLARED`` entry and
regenerating: ``python -m repro_torch.analysis --write-certificates``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.base import Finding

CERT_PATH = os.path.join(os.path.dirname(__file__), "certificates.json")
CERT_VERSION = 1

# Declared design claims, pinned per scheme (paper §III-B). "full_k" is the
# largest k ≤ MAX_K such that EVERY k-subset of data banks stays servable;
# "read_degree" counts simultaneous port-disjoint reads of one row
# (1 direct + disjoint parity options); "locality" is the worst-case bank
# count touched by one degraded read. A new scheme enters the simulator by
# adding its row here and regenerating certificates — no entry, no admit.
MAX_K = 2
DECLARED: Dict[str, Dict[str, int]] = {
    "uncoded": {"full_k": 0, "read_degree": 1, "locality": 1},
    "scheme_i": {"full_k": 2, "read_degree": 4, "locality": 2},
    # serving KV pool (runtime/kvbank.PooledKV): pairwise parities, one per
    # bank pair — a subcode of scheme_i (cross-checked by
    # ``check_pool_subcode``), so one degraded read per group per cycle.
    "kv_pool": {"full_k": 1, "read_degree": 2, "locality": 2},
    "scheme_ii": {"full_k": 2, "read_degree": 5, "locality": 2},
    "scheme_iii": {"full_k": 2, "read_degree": 4, "locality": 3},
    "replication_2": {"full_k": 2, "read_degree": 2, "locality": 1},
    "replication_4": {"full_k": 2, "read_degree": 4, "locality": 1},
}


# ------------------------------------------------------------------ GF(2)
def gf2_span_contains(rows: Sequence[int], target: int) -> bool:
    """True when ``target`` (a column bitmask) lies in the GF(2) row span."""
    basis: List[int] = []
    for r in rows:
        for b in basis:
            r = min(r, r ^ b)
        if r:
            basis.append(r)
            basis.sort(reverse=True)
    for b in basis:
        target = min(target, target ^ b)
    return target == 0


def gf2_recoverable(members: Sequence[Sequence[int]], n_data: int,
                    lost: Sequence[int]) -> bool:
    """Information-theoretic recoverability of ``lost`` data banks: the span
    of the alive unit vectors plus ALL parity rows must contain every lost
    unit vector (full elimination — strictly more powerful than the
    controller's single-decode serving rule)."""
    ls = set(lost)
    rows = [1 << m for m in range(n_data) if m not in ls]
    rows += [sum(1 << m for m in ms) for ms in members]
    return all(gf2_span_contains(rows, 1 << b) for b in ls)


def serving_recoverable(members: Sequence[Sequence[int]],
                        lost: Sequence[int]) -> bool:
    """The controller's degraded-serving rule, re-derived from the members
    matrix alone: each lost bank needs one parity whose other members are
    all alive (parity banks never fail — they are the redundancy; see
    docs/faults.md). Deliberately independent of
    ``CodeScheme.serving_recoverable`` so the two derivations check each
    other through the certificate."""
    ls = frozenset(lost)
    return all(
        any(b in ms and not (frozenset(ms) - {b}) & ls for ms in members)
        for b in ls)


# ----------------------------------------------------------- read capacity
def disjoint_read_capacity(members: Sequence[Sequence[int]],
                           phys: Sequence[int], n_data: int,
                           bank: int) -> int:
    """1 + the size of the largest set of pairwise port-disjoint parity
    options of ``bank`` (each option claims its physical parity port plus
    its sibling data-bank ports; the direct read claims only ``bank``'s own
    port, which no option touches). Exhaustive over ≤ MAX_OPTS options."""
    opts = []
    for j, ms in enumerate(members):
        if bank in ms:
            opts.append(frozenset({n_data + phys[j]})
                        | frozenset(m for m in ms if m != bank))
    best = 0
    for size in range(len(opts), 0, -1):
        for combo in itertools.combinations(opts, size):
            if len(frozenset().union(*combo)) == sum(len(o) for o in combo):
                best = size
                break
        if best:
            break
    return 1 + best


# ------------------------------------------------------------- table hash
def table_hash(members: Sequence[Sequence[int]],
               phys: Sequence[int]) -> str:
    """Canonical SHA-256 of a scheme's (members, phys) tables. Both the
    production tables and the oracle's independent derivation must hash to
    the same value (asserted via the certificate in conformance tests)."""
    doc = {"members": [sorted(int(m) for m in ms) for ms in members],
           "phys": [int(p) for p in phys]}
    blob = json.dumps(doc, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def diff_tables(name: str, core_members, core_phys,
                other_members, other_phys, other_label: str = "oracle"
                ) -> List[str]:
    """Human-readable field-level diff between two table derivations of one
    scheme — the error body when hashes diverge (names the scheme and the
    first differing parity instead of a bare assert)."""
    diffs: List[str] = []
    cm = [tuple(sorted(ms)) for ms in core_members]
    om = [tuple(sorted(ms)) for ms in other_members]
    if len(cm) != len(om):
        diffs.append(f"{name}: n_parities core={len(cm)} "
                     f"{other_label}={len(om)}")
    for j, (a, b) in enumerate(zip(cm, om)):
        if a != b:
            diffs.append(f"{name}: parity {j} members core={a} "
                         f"{other_label}={b}")
    cp, op = list(core_phys), list(other_phys)
    if cp != op:
        for j, (a, b) in enumerate(zip(cp, op)):
            if a != b:
                diffs.append(f"{name}: parity {j} phys core={a} "
                             f"{other_label}={b}")
        if len(cp) != len(op):
            diffs.append(f"{name}: phys length core={len(cp)} "
                         f"{other_label}={len(op)}")
    return diffs


# --------------------------------------------------------- stride aliasing
def stride_alias_free(rs_alloc: int, rs_active: int, n_slots: int,
                      n_rows: int) -> bool:
    """No two (slot, row) parity cells collide under padded addressing."""
    seen: Dict[int, Tuple[int, int]] = {}
    for slot in range(n_slots):
        for i in range(n_rows):
            pr = slot * rs_alloc + i % rs_active
            key = (slot, i % rs_active)
            prev = seen.get(pr)
            if prev is not None and prev != key:
                return False
            seen[pr] = key
            if not slot * rs_alloc <= pr < (slot + 1) * rs_alloc:
                return False
    return True


def check_stride_grid(max_rs: int = 8, max_slots: int = 4,
                      n_rows: int = 24) -> List[Finding]:
    """Exhaustive alias check over every padded geometry shape class the
    engine can produce: rs_active ≤ rs_alloc (group-max padding), any slot
    count. The row range covers several wrap-arounds of each stride."""
    out: List[Finding] = []
    for rs_alloc in range(1, max_rs + 1):
        for rs_active in range(1, rs_alloc + 1):
            for n_slots in range(1, max_slots + 1):
                if not stride_alias_free(rs_alloc, rs_active, n_slots, n_rows):
                    out.append(Finding(
                        "scheme-stride-alias",
                        f"geometry(rs_alloc={rs_alloc}, "
                        f"rs_active={rs_active}, n_slots={n_slots})",
                        "padded parity addressing aliases two slots"))
    return out


# ------------------------------------------------------------ certificates
def _scheme_tables(name: str):
    from repro_torch.core.codes import get_tables
    t = get_tables(name)
    return t.scheme.members, t.scheme.phys, t.n_data


def analyze_scheme(name: str,
                   members: Optional[Sequence[Sequence[int]]] = None,
                   phys: Optional[Sequence[int]] = None,
                   n_data: Optional[int] = None) -> Dict:
    """Full certificate entry for one scheme (from ``core.codes`` by default;
    explicit tables support analyzing candidate schemes before admission)."""
    if members is None:
        members, phys, n_data = _scheme_tables(name)
    assert phys is not None and n_data is not None
    serving: Dict[str, List[List[int]]] = {}
    gf2_counts: Dict[str, int] = {}
    full_k = 0
    for k in range(1, MAX_K + 1):
        servable = [list(lost) for lost
                    in itertools.combinations(range(n_data), k)
                    if serving_recoverable(members, lost)]
        serving[str(k)] = servable
        gf2_counts[str(k)] = sum(
            1 for lost in itertools.combinations(range(n_data), k)
            if gf2_recoverable(members, n_data, lost))
        if len(servable) == math.comb(n_data, k) and full_k == k - 1:
            full_k = k
    read_degree = [disjoint_read_capacity(members, phys, n_data, b)
                   for b in range(n_data)]
    locality = max((len(ms) for ms in members), default=1)
    return {
        "n_data": n_data,
        "n_parities": len(members),
        "n_phys": (max(phys) + 1) if phys else 0,
        "table_sha256": table_hash(members, phys),
        "read_degree": read_degree,
        "read_degree_min": min(read_degree),
        "locality": locality,
        "serving_tolerance": serving,
        "serving_tolerance_counts": {k: len(v) for k, v in serving.items()},
        "gf2_tolerance_counts": gf2_counts,
        "full_tolerance_k": full_k,
    }


def verify_scheme_claims(name: str, entry: Dict,
                         declared: Optional[Dict[str, int]] = None
                         ) -> List[Finding]:
    """Prove one analyzed scheme delivers its declared claims; and that the
    serving rule never claims more than GF(2) rank allows."""
    out: List[Finding] = []
    decl = declared if declared is not None else DECLARED.get(name)
    if decl is None:
        out.append(Finding(
            "scheme-undeclared", f"scheme:{name}",
            "no DECLARED claims entry — a scheme is admitted only with "
            "pinned erasure-tolerance/read-degree claims "
            "(repro_torch.analysis.schemes.DECLARED)"))
        return out
    if entry["full_tolerance_k"] < decl["full_k"]:
        missing = next(
            (lost for k in range(1, decl["full_k"] + 1)
             for lost in itertools.combinations(range(entry["n_data"]), k)
             if list(lost) not in entry["serving_tolerance"][str(k)]),
            None)
        out.append(Finding(
            "scheme-under-tolerant", f"scheme:{name}",
            f"declared full erasure tolerance k={decl['full_k']} but the "
            f"parity matrix only delivers k={entry['full_tolerance_k']} "
            f"(first unservable loss set: {missing})"))
    if entry["read_degree_min"] != decl["read_degree"]:
        out.append(Finding(
            "scheme-read-degree", f"scheme:{name}",
            f"declared read degree {decl['read_degree']} but the proven "
            f"port-disjoint capacity is {entry['read_degree_min']}"))
    if entry["locality"] != decl["locality"]:
        out.append(Finding(
            "scheme-locality", f"scheme:{name}",
            f"declared locality {decl['locality']} but the widest parity "
            f"touches {entry['locality']} banks"))
    # serving rule must be information-theoretically sound
    for k, servable in entry["serving_tolerance"].items():
        if len(servable) > entry["gf2_tolerance_counts"][k]:
            out.append(Finding(
                "scheme-serving-unsound", f"scheme:{name}",
                f"serving rule claims {len(servable)} recoverable "
                f"{k}-loss sets but GF(2) rank admits only "
                f"{entry['gf2_tolerance_counts'][k]}"))
    return out


KV_POOL_BANKS = 8


def pool_tables(n_banks: int = KV_POOL_BANKS):
    """(members, phys, n_data) of the serving KV pool's pairwise-parity
    layout, taken from the production table builder
    (``runtime.kvbank.parity_members``, which ``pool_init`` sizes its
    parity groups from) so the certificate proves the code the server
    runs."""
    from repro_torch.runtime.kvbank import parity_members
    members, phys = parity_members(n_banks)
    return members, phys, n_banks


def check_pool_subcode(n_banks: int = KV_POOL_BANKS,
                       parent: str = "scheme_i") -> List[Finding]:
    """The KV pool's parity layout must be a subcode of the core parent
    scheme: every pool parity group appears verbatim in the parent's
    members table (so the pool inherits the parent's certified claims
    restricted to those rows), and the groups partition the data banks."""
    out: List[Finding] = []
    members, _phys, nd = pool_tables(n_banks)
    pm, _pp, pn = _scheme_tables(parent)
    if pn != nd:
        out.append(Finding(
            "pool-subcode", f"kv_pool:{parent}",
            f"pool spans {nd} data banks but {parent} certifies {pn}"))
        return out
    parent_pairs = {tuple(sorted(ms)) for ms in pm}
    for g, ms in enumerate(members):
        if tuple(sorted(ms)) not in parent_pairs:
            out.append(Finding(
                "pool-subcode", f"kv_pool:parity{g}",
                f"pool parity group {tuple(ms)} is not a parity of "
                f"{parent} — the pool layout must be a subcode of the "
                "certified core scheme"))
    cover = sorted(m for ms in members for m in ms)
    if cover != list(range(nd)):
        out.append(Finding(
            "pool-subcode", "kv_pool:partition",
            f"pool parity groups must partition the data banks exactly "
            f"once; covered={cover}"))
    return out


def certify(names: Optional[Sequence[str]] = None) -> Dict:
    """The full certificate document: ``core.codes.SCHEMES`` plus the
    serving KV pool's pairwise layout (``kv_pool``)."""
    from repro_torch.core.codes import SCHEMES
    names = list(names) if names is not None \
        else sorted(SCHEMES) + ["kv_pool"]
    entries = {}
    for name in names:
        if name == "kv_pool":
            entries[name] = analyze_scheme(name, *pool_tables())
        else:
            entries[name] = analyze_scheme(name)
    return {
        "version": CERT_VERSION,
        "max_k": MAX_K,
        "schemes": entries,
    }


def load_certificates(path: str = CERT_PATH) -> Dict:
    with open(path) as f:
        return json.load(f)


def write_certificates(path: str = CERT_PATH) -> Dict:
    doc = certify()
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def verify_certificates(path: str = CERT_PATH) -> List[Finding]:
    """The gate: recompute every certificate and diff against the checked-in
    document; then prove every scheme's declared claims. A scheme edit
    without ``--write-certificates`` (or an under-delivering new scheme)
    fails here with the divergent scheme named."""
    out: List[Finding] = []
    live = certify()
    try:
        saved = load_certificates(path)
    except (OSError, ValueError) as e:
        return [Finding("scheme-cert-missing", path,
                        f"unreadable certificate document ({e}); run "
                        "python -m repro_torch.analysis --write-certificates")]
    if saved.get("version") != live["version"]:
        out.append(Finding("scheme-cert-stale", path,
                           f"certificate version {saved.get('version')} != "
                           f"analyzer version {live['version']}"))
    saved_schemes = saved.get("schemes", {})
    for name, entry in live["schemes"].items():
        have = saved_schemes.get(name)
        if have is None:
            out.append(Finding(
                "scheme-cert-stale", f"scheme:{name}",
                "no certificate for this scheme — run "
                "python -m repro_torch.analysis --write-certificates"))
            continue
        if have != entry:
            keys = sorted(k for k in entry
                          if have.get(k) != entry[k])
            out.append(Finding(
                "scheme-cert-stale", f"scheme:{name}",
                f"checked-in certificate diverges from the live tables in "
                f"{keys} (table hash live={entry['table_sha256'][:12]} "
                f"saved={str(have.get('table_sha256'))[:12]}); regenerate "
                "with python -m repro_torch.analysis --write-certificates"))
    for name in saved_schemes:
        if name not in live["schemes"]:
            out.append(Finding(
                "scheme-cert-stale", f"scheme:{name}",
                "certificate exists for a scheme no longer in "
                "core.codes.SCHEMES"))
    for name, entry in live["schemes"].items():
        out.extend(verify_scheme_claims(name, entry))
    return out


def run(strict: bool = False) -> List[Finding]:
    """Layer entry point: certificates + claims + stride-alias grid +
    KV-pool subcode cross-check."""
    del strict
    return (verify_certificates() + check_stride_grid()
            + check_pool_subcode())
