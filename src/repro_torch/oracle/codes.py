"""Coding schemes for the golden model, re-derived from the paper (§III).

A copy of the JAX package's ``repro/oracle/codes.py`` (the same code apart
from the package name). This module deliberately shares **no code** with
``repro_torch.core.codes``: the oracle exists to catch a shared
misconception, so even the scheme tables are derived independently from
the paper text. Conformance between the two derivations is asserted by
``tests/test_torch_oracle.py``.

A scheme is a list of *logical parity banks* over ``n_data`` single-port
data banks. Logical parity ``j`` stores, for every covered row ``i``,
``XOR_{m in members[j]} bank_m(i)`` (a single-member parity is a plain
duplicate). Each logical parity is hosted on a *physical* parity bank
(``phys[j]``); two logical parities packed onto one physical bank share its
single port (Scheme II packs two ``αL`` halves into one ``2αL`` bank).

Schemes (paper §III-B):

* **Scheme I** — data banks in groups of 4; all 6 pairwise XOR parities per
  group, one shallow physical bank each.
* **Scheme II** — Scheme I's pairs plus one duplicate per data bank, packed
  two *member-disjoint* halves per physical bank (complementary pairs
  share a bank, duplicates share a bank) so no data bank's serving options
  collide on one port.
* **Scheme III** — 9 data banks on a 3×3 grid; parities are the 3 row XORs,
  3 column XORs and 3 broken-diagonal XORs. With 8 data banks the 9th bank
  is simply omitted from every parity (paper Remark 5).
* **replication(k)** — ``k-1`` duplicates of every bank (§II-A1 baseline).
* **uncoded** — no parities.

Caps shared with the mode numbering: across the supported schemes a data
bank appears in at most ``MAX_OPTS = 4`` parities (Scheme II: 3 pairs + 1
duplicate) and a parity has at most ``MAX_SIBS = 2`` siblings per member
(Scheme III rows of 3). These bounds define the read/write action
numbering of the golden model (direct / option-k / redirect).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

MAX_SIBS = 2
MAX_OPTS = 4


@dataclasses.dataclass(frozen=True)
class OracleScheme:
    """Independent static description of one coding scheme."""

    name: str
    n_data: int
    members: Tuple[Tuple[int, ...], ...]   # logical parity -> data banks
    phys: Tuple[int, ...]                  # logical parity -> physical bank

    @property
    def n_parities(self) -> int:
        return len(self.members)

    @property
    def n_phys(self) -> int:
        return 0 if not self.phys else max(self.phys) + 1

    @property
    def n_ports(self) -> int:
        return self.n_data + self.n_phys

    def par_port(self, j: int) -> int:
        """Global single-port id charged by logical parity ``j``."""
        return self.n_data + self.phys[j]

    def options(self, b: int) -> List[Tuple[int, Tuple[int, ...]]]:
        """Non-direct serving options of data bank ``b``, in parity order:
        ``(parity j, sibling banks)`` — read parity ``j`` plus the siblings,
        XOR them to reconstruct ``b``'s row (no siblings = duplicate)."""
        opts = []
        for j, ms in enumerate(self.members):
            if b in ms:
                opts.append((j, tuple(m for m in ms if m != b)))
        assert len(opts) <= MAX_OPTS
        return opts


def _pairs(lo: int) -> List[Tuple[int, int]]:
    """All 6 unordered pairs of the 4-bank group starting at ``lo``, in
    lexicographic order."""
    g = range(lo, lo + 4)
    return [(a, b) for a in g for b in g if a < b]


def _scheme_i(n_data: int) -> OracleScheme:
    if n_data % 4:
        raise ValueError("Scheme I groups data banks by 4")
    members: List[Tuple[int, ...]] = []
    for g in range(0, n_data, 4):
        members.extend(_pairs(g))
    return OracleScheme("scheme_i", n_data, tuple(members),
                        tuple(range(len(members))))


def _scheme_ii(n_data: int) -> OracleScheme:
    if n_data % 4:
        raise ValueError("Scheme II groups data banks by 4")
    members: List[Tuple[int, ...]] = []
    phys: List[int] = []
    pbase = 0
    for g in range(0, n_data, 4):
        pairs = _pairs(g)
        dups = [(g + k,) for k in range(4)]
        # Each physical bank's two halves must cover disjoint data banks,
        # or the shared port costs some bank one of its 5 simultaneous
        # reads (§III-B2): complementary pairs together, duplicates
        # together.
        halves = [(pairs[0], pairs[5]), (pairs[1], pairs[4]),
                  (pairs[2], pairs[3]),
                  (dups[0], dups[1]), (dups[2], dups[3])]
        for k, (h0, h1) in enumerate(halves):
            members.extend([h0, h1])
            phys.extend([pbase + k, pbase + k])
        pbase += 5
    return OracleScheme("scheme_ii", n_data, tuple(members), tuple(phys))


def _scheme_iii(n_data: int) -> OracleScheme:
    if n_data not in (8, 9):
        raise ValueError("Scheme III uses a 3x3 grid (8 or 9 data banks)")
    grid = [[3 * r + c for c in range(3)] for r in range(3)]
    members: List[Tuple[int, ...]] = []
    members.extend(tuple(grid[r]) for r in range(3))                 # rows
    members.extend(tuple(grid[r][c] for r in range(3))               # columns
                   for c in range(3))
    members.extend(tuple(grid[k][(k + d) % 3] for k in range(3))     # diagonals
                   for d in range(3))
    if n_data == 8:
        members = [tuple(m for m in ms if m != 8) for ms in members]
    return OracleScheme("scheme_iii", n_data, tuple(members),
                        tuple(range(len(members))))


def _replication(n_data: int, copies: int) -> OracleScheme:
    members: List[Tuple[int, ...]] = []
    phys: List[int] = []
    for c in range(copies - 1):
        for b in range(n_data):
            members.append((b,))
            phys.append(c * n_data + b)
    return OracleScheme(f"replication_{copies}", n_data, tuple(members),
                        tuple(phys))


def oracle_scheme(name: str, n_data: int = 8) -> OracleScheme:
    """Build the named scheme's tables from the paper's definitions."""
    if name == "uncoded":
        return OracleScheme("uncoded", n_data, (), ())
    if name == "scheme_i":
        return _scheme_i(n_data)
    if name == "scheme_ii":
        return _scheme_ii(n_data)
    if name == "scheme_iii":
        return _scheme_iii(n_data)
    if name.startswith("replication_"):
        return _replication(n_data, int(name.split("_")[-1]))
    raise KeyError(f"unknown scheme {name!r}")


ORACLE_SCHEMES: Dict[str, str] = {
    name: name for name in ("uncoded", "scheme_i", "scheme_ii", "scheme_iii",
                            "replication_2", "replication_4")
}
