"""Code schemes of the paper (§III) as static, table-driven descriptions.

The port's own copy of ``repro/core/codes.py`` (NumPy only): the same
schemes, the same logical-to-physical parity packing and the same dense
lookup tables, so plans built from them equal the JAX package's.

A *scheme* is a set of logical parity banks over ``n_data`` single-port
data banks. Logical parity ``j`` stores, for every covered row ``i``,
``XOR_{m in members[j]} bank_m(i)``; ``members`` of size 1 is a straight
duplicate. Logical parities live on physical parity banks (``phys``); two
logical parities packed into one physical bank share its single port.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np

MAX_SIBS = 2  # max locality-1 across supported schemes (Scheme III = 3 banks)
MAX_OPTS = 4  # max non-direct serving options for one data bank


@dataclasses.dataclass(frozen=True)
class CodeScheme:
    """Static description of a coding scheme."""

    name: str
    n_data: int
    members: Tuple[Tuple[int, ...], ...]
    phys: Tuple[int, ...]

    @property
    def n_parities(self) -> int:
        return len(self.members)

    @property
    def n_phys(self) -> int:
        return 0 if not self.phys else max(self.phys) + 1

    @property
    def n_ports(self) -> int:
        """Total single-port units: data banks + physical parity banks."""
        return self.n_data + self.n_phys

    def storage_overhead(self, alpha: float) -> float:
        """Parity storage in units of one data bank (αL rows each logical)."""
        return self.n_parities * alpha

    def rate(self, alpha: float) -> float:
        """Information rate = data / (data + parity) storage (paper §III-B)."""
        return self.n_data / (self.n_data + self.storage_overhead(alpha))

    def locality(self) -> int:
        """Worst-case degraded-read locality (banks touched per read)."""
        return max((len(m) for m in self.members), default=1)

    # --------------------------------------------------- erasure tolerance
    def serving_recoverable(self, lost) -> bool:
        """True when every data bank in ``lost`` stays readable under the
        controller's degraded serving rule: one parity option per read, all
        of whose other members are alive (parity banks never fail in the
        fault model). This is the single-decode rule the pattern builders
        implement, not full GF(2) elimination, so a loss set rejected here
        is what ``repro_torch.faults`` fail-fast-drops."""
        ls = frozenset(lost)
        for b in ls:
            if not 0 <= b < self.n_data:
                raise ValueError(f"lost bank {b} out of range "
                                 f"[0, {self.n_data})")
            if not any(b in ms and not (frozenset(ms) - {b}) & ls
                       for ms in self.members):
                return False
        return True

    def erasure_tolerance(self, max_losses: int = 2):
        """{k: tuple of k-subsets of data banks that remain fully readable}
        for k = 1 .. ``max_losses``, under ``serving_recoverable``."""
        return {
            k: tuple(lost for lost
                     in itertools.combinations(range(self.n_data), k)
                     if self.serving_recoverable(lost))
            for k in range(1, max_losses + 1)
        }


def scheme_i(n_data: int = 8) -> CodeScheme:
    assert n_data % 4 == 0, "Scheme I groups data banks by 4"
    members = []
    for g in range(n_data // 4):
        base = 4 * g
        for a, b in itertools.combinations(range(base, base + 4), 2):
            members.append((a, b))
    phys = tuple(range(len(members)))  # one shallow physical bank per parity
    return CodeScheme("scheme_i", n_data, tuple(members), phys)


def scheme_ii(n_data: int = 8) -> CodeScheme:
    assert n_data % 4 == 0, "Scheme II groups data banks by 4"
    members = []
    phys = []
    phys_base = 0
    for g in range(n_data // 4):
        base = 4 * g
        pairs = list(itertools.combinations(range(base, base + 4), 2))  # 6
        dups = [(base + k,) for k in range(4)]  # 4
        # 10 logical halves in 5 physical banks of 2αL rows; each physical
        # bank's two halves are member-disjoint (a pair with its
        # complement, duplicates together), so every data bank keeps its
        # five simultaneous reads (paper §III-B2)
        packing = [
            (pairs[0], pairs[5]),   # (0,1) + (2,3)
            (pairs[1], pairs[4]),   # (0,2) + (1,3)
            (pairs[2], pairs[3]),   # (0,3) + (1,2)
            (dups[0], dups[1]),
            (dups[2], dups[3]),
        ]
        for k, (h0, h1) in enumerate(packing):
            members.append(h0)
            phys.append(phys_base + k)
            members.append(h1)
            phys.append(phys_base + k)
        phys_base += 5
    return CodeScheme("scheme_ii", n_data, tuple(members), tuple(phys))


def scheme_iii(n_data: int = 9) -> CodeScheme:
    """3×3 grid code: rows / columns / broken diagonals; locality 3.

    With ``n_data == 8`` the 9th bank is left out of the encoding (paper
    Remark 5): parities that referenced it drop that member.
    """
    assert n_data in (8, 9)
    grid = np.arange(9).reshape(3, 3)
    members = []
    for r in range(3):  # rows
        members.append(tuple(int(x) for x in grid[r]))
    for c in range(3):  # columns
        members.append(tuple(int(x) for x in grid[:, c]))
    for d in range(3):  # broken diagonals
        members.append(tuple(int(grid[k, (k + d) % 3]) for k in range(3)))
    if n_data == 8:
        members = [tuple(m for m in ms if m != 8) for ms in members]
    phys = tuple(range(len(members)))
    return CodeScheme("scheme_iii", n_data, tuple(members), phys)


def replication(n_data: int = 8, copies: int = 2) -> CodeScheme:
    """k-replication baseline (§II-A1): copies-1 duplicates per data bank."""
    members = []
    phys = []
    p = 0
    for _ in range(copies - 1):
        for b in range(n_data):
            members.append((b,))
            phys.append(p)
            p += 1
    return CodeScheme(f"replication_{copies}", n_data, tuple(members),
                      tuple(phys))


def uncoded(n_data: int = 8) -> CodeScheme:
    return CodeScheme("uncoded", n_data, (), ())


SCHEMES = {
    "uncoded": uncoded,
    "scheme_i": scheme_i,
    "scheme_ii": scheme_ii,
    "scheme_iii": scheme_iii,
    "replication_2": lambda n_data=8: replication(n_data, 2),
    "replication_4": lambda n_data=8: replication(n_data, 4),
}


@dataclasses.dataclass(frozen=True)
class CodeTables:
    """Dense numpy lookup tables consumed by the pattern builders.

    All arrays use -1 padding. ``opt_*`` enumerate the *non-direct* serving
    options of each data bank: option k of bank b reads logical parity
    ``opt_parity[b, k]`` plus sibling data banks ``opt_sibs[b, k, :]``.
    """

    scheme: CodeScheme
    n_data: int
    n_parities: int
    n_phys: int
    n_ports: int
    par_members: np.ndarray  # (n_par, MAX_SIBS+1) int32, -1 pad
    par_phys: np.ndarray     # (n_par,) int32  physical parity bank
    par_port: np.ndarray     # (n_par,) int32  global port id (n_data + phys)
    opt_parity: np.ndarray   # (n_data, MAX_OPTS) int32, -1 pad
    opt_sibs: np.ndarray     # (n_data, MAX_OPTS, MAX_SIBS) int32, -1 pad
    opt_n: np.ndarray        # (n_data,) int32 number of valid options

    @staticmethod
    def build(scheme: CodeScheme) -> "CodeTables":
        nd, npar = scheme.n_data, scheme.n_parities
        par_members = np.full((max(npar, 1), MAX_SIBS + 1), -1, np.int32)
        par_phys = np.full((max(npar, 1),), -1, np.int32)
        for j, ms in enumerate(scheme.members):
            assert len(ms) <= MAX_SIBS + 1
            par_members[j, : len(ms)] = ms
            par_phys[j] = scheme.phys[j]
        par_port = np.where(par_phys >= 0, nd + par_phys, -1).astype(np.int32)

        opt_parity = np.full((nd, MAX_OPTS), -1, np.int32)
        opt_sibs = np.full((nd, MAX_OPTS, MAX_SIBS), -1, np.int32)
        opt_n = np.zeros((nd,), np.int32)
        for b in range(nd):
            k = 0
            for j, ms in enumerate(scheme.members):
                if b in ms:
                    assert k < MAX_OPTS, f"bank {b}: more than {MAX_OPTS} options"
                    opt_parity[b, k] = j
                    sibs = [m for m in ms if m != b]
                    opt_sibs[b, k, : len(sibs)] = sibs
                    k += 1
            opt_n[b] = k
        return CodeTables(
            scheme=scheme, n_data=nd, n_parities=npar, n_phys=scheme.n_phys,
            n_ports=scheme.n_ports, par_members=par_members,
            par_phys=par_phys, par_port=par_port, opt_parity=opt_parity,
            opt_sibs=opt_sibs, opt_n=opt_n)


def get_tables(name: str, n_data: int = 8) -> CodeTables:
    if name not in SCHEMES:
        raise KeyError(f"unknown scheme {name!r}; have {sorted(SCHEMES)}")
    if name == "scheme_iii" and n_data == 8:
        return CodeTables.build(scheme_iii(8))
    return CodeTables.build(SCHEMES[name](n_data=n_data))
