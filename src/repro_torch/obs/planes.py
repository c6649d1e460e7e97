"""Device-side telemetry metric planes (the ``MemParams.telemetry``
payload); the port of ``repro/obs/planes.py``.

A plane is a small counter tensor carried in the state and updated by the
cycle engine beside the scatters it already makes. The planes answer what
the three aggregates (``stall_cycles``, ``read/write_latency_sum``)
cannot: which bank stalled a core, why a queued request waited, how each
core's reads were served (direct, decoded, redirected, or degraded
because their bank is down), how deep the queues ran, and how the
critical-word latency distributes (the paper's headline metric, as a
log2 histogram instead of a sum).

Cause taxonomy (the JAX package's, unchanged):

* ``stall_cause[b, c]``: arbiter stalls by destination data bank, ``c=0``
  read queue full, ``c=1`` write queue full; sums to ``stall_cycles``.
* ``wait_cause[b, c]``: per-cycle pending work by bank, ``c=0`` a valid
  read unserved in a read cycle, ``c=1`` a valid write unserved in a write
  cycle, ``c=2`` a recode-ring entry still pending at cycle end.
* ``read_mode_core[core, k]``: served reads by issuing core, ``k`` in
  ``READ_CLASSES``; sums to ``served_reads``, classes 1 + 2 + 4 to
  ``degraded_reads`` (class 4 only with faults on).
* ``write_mode_core[core, k]``: ``k=0`` direct, ``k=1`` parked.
* ``rq_hwm`` / ``wq_hwm``: post-arbiter per-bank queue high-water marks.
* ``lat_hist_read`` / ``lat_hist_write``: log2 critical-word latency
  histograms over served requests (``lat_bin``).
* ``recode_retired``: recode-ring retirements.
* ``rq_core`` / ``wq_core``: the core id in each queue slot, written in
  the same scatter as the slot (provenance carriers, not counters).
* ``dead_cycles``: per-bank cycles spent down; equals
  ``FaultState.dead_cycles`` (all zero with faults off).

Representation: every leaf has a leading (B,) point axis in a batched
state, like every other leaf of the port's ``MemState``. The counters
that JAX keeps as uint32 (``COUNTER_FIELDS``) are int64 here: torch on the
CPU has no ``index_put`` for uint32. JAX's would wrap at 2**32 counts; no
run of this repository comes near that, so the values are the same
(``repro_torch.convert`` maps between the two). The high-water marks and
the provenance carriers stay int32, as in JAX.

This module imports nothing of ``repro_torch`` (``core.state`` imports it
for the leaf type).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

STALL_CAUSES = ("read_queue_full", "write_queue_full")
WAIT_CAUSES = ("read_conflict", "write_conflict", "recode_pending")
# ``degraded_fault``: a from_sym / parity-decode serve whose bank is down
# (fault injection, repro_torch.faults) rather than merely busy
READ_CLASSES = ("direct", "from_sym", "parity_decode", "redirect",
                "degraded_fault")
WRITE_CLASSES = ("direct", "parked")
WAIT_READ, WAIT_WRITE, WAIT_RECODE = range(len(WAIT_CAUSES))
HIST_BINS = 16


class Telemetry(NamedTuple):
    """One point's metric planes (shapes below; a batch adds a leading
    (B,) axis)."""

    stall_cause: torch.Tensor      # (n_data, 2) int64
    wait_cause: torch.Tensor       # (n_data, 3) int64
    read_mode_core: torch.Tensor   # (n_cores, 5) int64
    write_mode_core: torch.Tensor  # (n_cores, 2) int64
    rq_hwm: torch.Tensor           # (n_data,) int32
    wq_hwm: torch.Tensor           # (n_data,) int32
    lat_hist_read: torch.Tensor    # (HIST_BINS,) int64
    lat_hist_write: torch.Tensor   # (HIST_BINS,) int64
    recode_retired: torch.Tensor   # () int64
    rq_core: torch.Tensor          # (n_data, queue_depth) int32
    wq_core: torch.Tensor          # (n_data, queue_depth) int32
    dead_cycles: torch.Tensor      # (n_data,) int64


# the planes JAX keeps as uint32 (int64 in the port)
COUNTER_FIELDS = ("stall_cause", "wait_cause", "read_mode_core",
                  "write_mode_core", "lat_hist_read", "lat_hist_write",
                  "recode_retired", "dead_cycles")


def init_telemetries(n_points: int, n_data: int, n_cores: int,
                     queue_depth: int, device="cpu") -> Telemetry:
    """Zeroed planes of ``n_points`` points (leading point axis) on
    ``device``; the provenance carriers start at -1."""
    def z(*shape, dtype=torch.int64, fill=0):
        return torch.full((n_points, *shape), fill, dtype=dtype,
                          device=device)

    return Telemetry(
        stall_cause=z(n_data, len(STALL_CAUSES)),
        wait_cause=z(n_data, len(WAIT_CAUSES)),
        read_mode_core=z(n_cores, len(READ_CLASSES)),
        write_mode_core=z(n_cores, len(WRITE_CLASSES)),
        rq_hwm=z(n_data, dtype=torch.int32),
        wq_hwm=z(n_data, dtype=torch.int32),
        lat_hist_read=z(HIST_BINS),
        lat_hist_write=z(HIST_BINS),
        recode_retired=z(),
        rq_core=z(n_data, queue_depth, dtype=torch.int32, fill=-1),
        wq_core=z(n_data, queue_depth, dtype=torch.int32, fill=-1),
        dead_cycles=z(n_data),
    )


def init_telemetry(n_data: int, n_cores: int, queue_depth: int,
                   device="cpu") -> Telemetry:
    """One point's zeroed planes (no point axis)."""
    return Telemetry(*(x[0] for x in init_telemetries(
        1, n_data, n_cores, queue_depth, device)))


def lat_bin(lat: torch.Tensor) -> torch.Tensor:
    """log2 histogram bin of a latency: 0 -> 0, 1 -> 1, [2, 3] -> 2,
    [4, 7] -> 3, ..., clamped into the open-ended last bin. A threshold
    count (no float log), integer-exact as JAX's."""
    thresholds = 2 ** torch.arange(HIST_BINS - 1, dtype=lat.dtype,
                                   device=lat.device)
    return (lat[..., None] >= thresholds).sum(-1)


# ------------------------------------------------------------- host snapshot
def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


class TelemetrySnapshot:
    """Host-side (numpy int64) view of one point's planes, with the
    derived totals the reports and tests check against ``SimResult``.
    Build it with ``snapshot``."""

    def __init__(self, tele):
        for name in Telemetry._fields:
            setattr(self, name, _host(getattr(tele, name)))

    def stall_total(self) -> int:
        return int(self.stall_cause.sum())

    def stall_by_cause(self) -> dict:
        return {c: int(self.stall_cause[:, k].sum())
                for k, c in enumerate(STALL_CAUSES)}

    def wait_by_cause(self) -> dict:
        return {c: int(self.wait_cause[:, k].sum())
                for k, c in enumerate(WAIT_CAUSES)}

    def reads_by_class(self) -> dict:
        return {c: int(self.read_mode_core[:, k].sum())
                for k, c in enumerate(READ_CLASSES)}

    def writes_by_class(self) -> dict:
        return {c: int(self.write_mode_core[:, k].sum())
                for k, c in enumerate(WRITE_CLASSES)}

    def served_reads(self) -> int:
        return int(self.read_mode_core.sum())

    def served_writes(self) -> int:
        return int(self.write_mode_core.sum())

    def degraded_reads(self) -> int:
        by = self.reads_by_class()
        return by["from_sym"] + by["parity_decode"] + by["degraded_fault"]

    def fault_degraded_reads(self) -> int:
        return self.reads_by_class()["degraded_fault"]

    def dead_bank_cycles(self) -> int:
        return int(self.dead_cycles.sum())

    def parked_writes(self) -> int:
        return self.writes_by_class()["parked"]

    def as_dict(self) -> dict:
        """JSON-ready dump: the counter planes and the derived totals (the
        provenance carriers are transient state, not metrics)."""
        out = {name: getattr(self, name).tolist()
               for name in Telemetry._fields
               if name not in ("rq_core", "wq_core")}
        out["recode_retired"] = int(self.recode_retired)
        out["derived"] = {
            "stall_total": self.stall_total(),
            "served_reads": self.served_reads(),
            "served_writes": self.served_writes(),
            "degraded_reads": self.degraded_reads(),
            "parked_writes": self.parked_writes(),
            "stall_by_cause": self.stall_by_cause(),
            "wait_by_cause": self.wait_by_cause(),
            "reads_by_class": self.reads_by_class(),
            "writes_by_class": self.writes_by_class(),
            "fault_degraded_reads": self.fault_degraded_reads(),
            "dead_bank_cycles": self.dead_bank_cycles(),
        }
        return out


def _find_tele(obj):
    if obj is None or isinstance(obj, Telemetry):
        return obj
    t = getattr(obj, "tele", None)
    if t is not None:
        return t
    m = getattr(obj, "mem", None)
    return getattr(m, "tele", None) if m is not None else None


def snapshot(obj, point: Optional[int] = None
             ) -> Optional[TelemetrySnapshot]:
    """Host snapshot of the planes in ``obj``: a ``Telemetry``, a
    ``MemState`` or a ``SimState``. ``point`` indexes the leading point
    axis of a batched state. None when telemetry is off."""
    tele = _find_tele(obj)
    if tele is None:
        return None
    if point is not None:
        tele = Telemetry(*(leaf[point] for leaf in tele))
    return TelemetrySnapshot(tele)
