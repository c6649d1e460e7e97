"""Pure-NumPy golden model of the coded memory system.

A copy of the JAX package's ``repro/oracle/model.py``, which the port may
not import: the code is the same apart from the package name
(``tests/test_torch_oracle.py`` holds the two equal by their syntax trees
and by their results). It is the **oracle** the port's simulator
(``repro_torch.core``, batched torch on the card) is checked against: a
deliberately dumb, one-request-at-a-time re-derivation of the paper's
cycle semantics (§IV, Algorithms/Figs 9–14). Every structure is a plain
python loop over small numpy arrays; there are **no torch imports and no
code shared with** ``repro_torch.core`` — the point of the oracle is to
catch a misconception the card and CPU paths of the port could share (the
differential-testing pattern used to validate algorithmic multi-port
designs against RTL golden models).

One ``cycle()`` call = one memory clock cycle:

1. **Core arbiter** — cores in index order push their pending request into
   the destination bank's read/write queue (first free slot); a full queue
   stalls the core and counts a stall cycle.
2. **Write-drain hysteresis** — serve writes when the fullest write queue
   crosses ``wq_hi`` (staying in write mode while above ``wq_lo``), or when
   only writes are pending; otherwise serve reads.
3. **Pattern builder** — candidates are visited oldest-first (stable on
   queue position); each takes the cheapest feasible action, where cost
   counts the single-port banks claimed and parity-based service is
   preferred over a direct read on cost ties:
   reads — reuse a row already materialized this cycle (free, chained
   decode) / degraded read via a parity option (parity port + missing
   siblings) / redirect to the parked fresh copy / direct read;
   writes — direct (preferred when the bank port is free) / park the raw
   value into a covering parity row.
4. **Datapath** — served reads return the direct / XOR-decoded / redirected
   value; served writes commit oldest-first (last write wins), parking into
   parity rows when chosen. ``golden`` records memory order.
5. **ReCoding unit** — scans the pending ring in order and retires up to
   ``recode_budget`` entries whose ports are all idle: restore a parked
   value to its data bank, recompute the stale covering parities from the
   data banks (skipping parities blocked by *another* member's parked
   value, which are invalidated instead when the restore changed the bank).
6. **Dynamic coding unit** — in-flight encode countdown and completion;
   every ``select_period`` cycles encode the hottest uncoded region into a
   free slot, or evict the coldest coded region (LFU, blocked while it
   holds parked writes) when strictly colder; windowed counts halve each
   period. Quiesces after the workload drains.

The model runs at a *point's own* geometry inside an optionally padded
allocation (``region_size/n_regions/n_slots`` vs the ``*_active`` values),
mirroring the sweep engine's masked α×r batching, so padded grid points can
be conformance-checked too.

``repro_torch.sim.golden`` builds a port system's twin and names the
fields that differ; ``chip_smoke.py`` holds the card's simulator against
it and ``tests/test_torch_oracle.py`` the port's CPU path.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np

from repro_torch.oracle.codes import MAX_OPTS, OracleScheme, oracle_scheme

INT32_MAX = np.iinfo(np.int32).max

# read action numbering (shared contract with the production scheduler's
# ReadPlan.mode; asserted equal by the conformance suite)
MODE_UNSERVED = -1
MODE_FROM_SYM = 0
MODE_DIRECT = 1
MODE_OPT0 = 2
MODE_REDIRECT = MODE_OPT0 + MAX_OPTS
# write action numbering
WMODE_UNSERVED = -1
WMODE_DIRECT = 0
WMODE_PARK0 = 1


@dataclasses.dataclass(frozen=True)
class OracleParams:
    """Static + per-point knobs of the golden model (plain python ints)."""

    n_data: int
    n_rows: int
    region_size: int        # allocated parity-slot stride
    n_regions: int          # allocated
    n_slots: int            # allocated (>= 1 storage floor)
    n_active: int           # true parity-slot budget (0 when alpha < r)
    queue_depth: int = 10
    recode_cap: int = 64
    recode_budget: int = 4
    coalesce: bool = True
    encode_rows_per_cycle: int = 64
    # the point's own geometry inside the allocation
    region_size_active: int = 0     # 0 -> the allocation is the geometry
    n_regions_active: int = 0
    n_slots_active: int = INT32_MAX
    # tunables (the write-drain hysteresis + dynamic selection period)
    select_period: int = 512
    wq_hi: int = 8
    wq_lo: int = 2
    # mirror of MemParams.telemetry: carry independently-derived metric
    # planes (OracleTelemetry) so the conformance suite can assert the
    # production planes against a second implementation
    telemetry: bool = False
    # mirror of MemParams.faults: carry an independently-derived fault
    # schedule/progress leaf (OracleFaultState) re-deriving every rule of
    # repro_torch.faults sequentially — erasure-degraded serving, fail-fast
    # drops, port stutters and the online rebuild sweep
    faults: bool = False

    @property
    def rs_active(self) -> int:
        return self.region_size_active or self.region_size

    @property
    def nr_active(self) -> int:
        return self.n_regions_active or self.n_regions

    @property
    def slot_budget(self) -> int:
        return min(self.n_slots_active, self.n_active)

    @staticmethod
    def derive(n_rows: int, alpha: float, r: float, *,
               region_size_alloc: Optional[int] = None,
               n_regions_alloc: Optional[int] = None,
               n_slots_alloc: Optional[int] = None,
               n_data: int = 8, **kw) -> "OracleParams":
        """Geometry implied by an (n_rows, α, r) point (paper §IV-E):
        regions of ``round(L·r)`` rows, a parity budget of ``⌊α/r⌋`` slots
        (0 when α < r — the point is uncoded), optionally inside a padded
        group allocation whose active geometry stays the derived one."""
        rs = max(1, int(round(n_rows * r)))
        nr = -(-n_rows // rs)
        ns = max(min(int(np.floor(alpha / r + 1e-9)), nr), 0)
        alloc_rs = region_size_alloc if region_size_alloc is not None else rs
        alloc_nr = n_regions_alloc if n_regions_alloc is not None else nr
        alloc_ns = n_slots_alloc if n_slots_alloc is not None else ns
        return OracleParams(
            n_data=n_data, n_rows=n_rows,
            region_size=alloc_rs, n_regions=alloc_nr,
            n_slots=max(alloc_ns, 1), n_active=alloc_ns,
            region_size_active=rs, n_regions_active=nr, n_slots_active=ns,
            **kw)


class OracleReadPlan(NamedTuple):
    served: np.ndarray
    mode: np.ndarray
    port_busy: np.ndarray
    n_served: int
    n_degraded: int


class OracleWritePlan(NamedTuple):
    served: np.ndarray
    mode: np.ndarray
    port_busy: np.ndarray
    fresh_loc: np.ndarray
    parity_valid: np.ndarray
    parked_count: np.ndarray
    rc_bank: np.ndarray
    rc_row: np.ndarray
    rc_valid: np.ndarray
    n_served: int
    n_parked: int
    n_rc_dropped: int


class OracleRecodeOut(NamedTuple):
    port_busy: np.ndarray
    fresh_loc: np.ndarray
    parity_valid: np.ndarray
    parked_count: np.ndarray
    rc_valid: np.ndarray
    banks_data: np.ndarray
    parity_data: np.ndarray
    n_recoded: int


class OracleResult(NamedTuple):
    """Field-for-field the production ``SimResult`` (same tuple layout, so
    ``strip_windows(sim_result) == oracle_result`` compares directly)."""

    cycles: int
    completed: bool
    served_reads: int
    served_writes: int
    degraded_reads: int
    parked_writes: int
    switches: int
    recode_backlog: int
    stall_cycles: int
    avg_read_latency: float
    avg_write_latency: float
    rc_dropped: int = 0
    window_read_latency: tuple = ()
    window_write_latency: tuple = ()
    # fault-injection availability stats (mirrors SimResult; 0 = faults off)
    unserved_reads: int = 0
    lost_writes: int = 0
    fault_degraded_reads: int = 0
    dead_bank_cycles: int = 0


# telemetry histogram geometry — independently fixed here (NOT imported from
# repro_torch.obs; the oracle shares no code with the production path)
ORACLE_HIST_BINS = 16


def _lat_bin(lat: int) -> int:
    """log2 latency bin: 0→0, 1→1, [2,3]→2, [4,7]→3, … — ``bit_length`` is
    an independent derivation of the production threshold-count binning."""
    return min(int(lat).bit_length(), ORACLE_HIST_BINS - 1)


@dataclasses.dataclass
class OracleTelemetry:
    """Golden-model metric planes (fields named like the production
    ``repro_torch.obs.planes.Telemetry`` leaves, so conformance compares by
    name). All plain int64 numpy — magnitudes are trace-bounded."""

    stall_cause: np.ndarray       # (n_data, 2) {read,write}-queue-full
    wait_cause: np.ndarray        # (n_data, 3) {read,write,recode} waits
    read_mode_core: np.ndarray    # (n_cores, 5) {direct,from_sym,parity,
                                  #               redirect,degraded_fault}
    write_mode_core: np.ndarray   # (n_cores, 2) {direct, parked}
    rq_hwm: np.ndarray            # (n_data,) post-arbiter high-water marks
    wq_hwm: np.ndarray
    lat_hist_read: np.ndarray     # (ORACLE_HIST_BINS,)
    lat_hist_write: np.ndarray
    recode_retired: int
    rq_core: np.ndarray           # (n_data, D) issuing-core provenance
    wq_core: np.ndarray
    dead_cycles: np.ndarray       # (n_data,) per-bank cycles spent down


def _init_oracle_telemetry(n_data: int, n_cores: int,
                           queue_depth: int) -> OracleTelemetry:
    z = lambda *s: np.zeros(s, np.int64)                      # noqa: E731
    return OracleTelemetry(
        stall_cause=z(n_data, 2), wait_cause=z(n_data, 3),
        read_mode_core=z(n_cores, 5), write_mode_core=z(n_cores, 2),
        rq_hwm=z(n_data), wq_hwm=z(n_data),
        lat_hist_read=z(ORACLE_HIST_BINS), lat_hist_write=z(ORACLE_HIST_BINS),
        recode_retired=0,
        rq_core=np.full((n_data, queue_depth), -1, np.int64),
        wq_core=np.full((n_data, queue_depth), -1, np.int64),
        dead_cycles=z(n_data),
    )


@dataclasses.dataclass
class OracleFaultState:
    """Golden-model fault schedule + progress (fields named like the
    production ``repro_torch.faults.plan.FaultState`` leaf, so conformance
    compares by name). The schedule half is constant over a run; the rest
    mutates each cycle. Semantics are re-derived sequentially in
    ``OracleMemorySystem.cycle`` — only the *schedule arrays* come from the
    host-side plan (input data, like the trace), never the rules."""

    fail_at: np.ndarray          # (n_data,) int32; INT32_MAX = never
    recover_at: np.ndarray       # (n_data,) int32; INT32_MAX = never
    stutter_period: np.ndarray   # (n_ports,) int32; 0 = no stutter
    stutter_phase: np.ndarray    # (n_ports,) int32
    rebuilt: np.ndarray          # (n_data,) bool — rebuild-complete latch
    rebuild_ptr: int             # flat (bank*n_rows+row) sweep cursor
    unserved_reads: int          # reads failed fast (no serving option)
    lost_writes: int             # writes dropped with no parity coverage
    fault_degraded: int          # reads degraded *because* bank down
    dead_cycles: np.ndarray      # (n_data,) cycles spent down


def _init_oracle_fault(n_data: int, n_ports: int,
                       fault_plan=None) -> OracleFaultState:
    """No-fault schedule, or the one in ``fault_plan`` (duck-typed: any
    object with a numpy ``schedule_arrays()`` — the production
    ``repro_torch.faults.FaultPlan``; the oracle imports nothing from it)."""
    if fault_plan is not None:
        fail, rec, per, ph = (np.array(a, np.int32)
                              for a in fault_plan.schedule_arrays())
    else:
        fail = np.full(n_data, INT32_MAX, np.int32)
        rec = np.full(n_data, INT32_MAX, np.int32)
        per = np.zeros(n_ports, np.int32)
        ph = np.zeros(n_ports, np.int32)
    return OracleFaultState(
        fail_at=fail, recover_at=rec, stutter_period=per, stutter_phase=ph,
        rebuilt=np.zeros(n_data, bool), rebuild_ptr=0,
        unserved_reads=0, lost_writes=0, fault_degraded=0,
        dead_cycles=np.zeros(n_data, np.int64),
    )


@dataclasses.dataclass
class OracleState:
    """Mutable model state (numpy arrays named like the production
    ``MemState``/``SimState`` leaves, so conformance compares by name)."""

    fresh_loc: np.ndarray
    parity_valid: np.ndarray
    region_slot: np.ndarray
    slot_region: np.ndarray
    access_count: np.ndarray
    parked_count: np.ndarray
    enc_region: int
    enc_remaining: int
    enc_slot: int
    switches: int
    rc_bank: np.ndarray
    rc_row: np.ndarray
    rc_valid: np.ndarray
    rq_row: np.ndarray
    rq_age: np.ndarray
    rq_valid: np.ndarray
    wq_row: np.ndarray
    wq_age: np.ndarray
    wq_valid: np.ndarray
    wq_data: np.ndarray
    write_mode: bool
    cycle: int
    banks_data: np.ndarray
    parity_data: np.ndarray
    golden: np.ndarray
    served_reads: int
    served_writes: int
    degraded_reads: int
    parked_writes: int
    read_latency_sum: int
    write_latency_sum: int
    stall_cycles: int
    rc_dropped: int
    core_ptr: np.ndarray
    done_cycle: int
    tele: Optional[OracleTelemetry] = None
    fault: Optional[OracleFaultState] = None


class OracleCycleOut(NamedTuple):
    """Per-cycle read-datapath view (mirrors the production ``CycleOut``)."""

    r_served: np.ndarray
    r_bank: np.ndarray
    r_row: np.ndarray
    r_value: np.ndarray
    n_served: int


def _stable_age_order(age, valid) -> np.ndarray:
    """Oldest-first candidate order, stable on queue position; invalid
    entries sort to the back (they are no-ops in every walk)."""
    return np.argsort(np.where(valid, age, INT32_MAX), kind="stable")


def build_read_plan(sys: "OracleMemorySystem", cand_bank, cand_row, cand_age,
                    cand_valid, port_busy, fresh_loc, parity_valid,
                    region_slot, rs_active: Optional[int] = None
                    ) -> OracleReadPlan:
    """Greedy oldest-first read matcher (paper Fig 11 / §IV-B)."""
    p, sch = sys.p, sys.scheme
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    n = len(cand_bank)
    port_busy = np.array(port_busy, bool)
    served = np.zeros(n, bool)
    mode = np.full(n, MODE_UNSERVED, np.int32)
    syms = set()                        # (bank, row) materialized this cycle
    for c in _stable_age_order(cand_age, cand_valid):
        if not cand_valid[c]:
            continue
        b = max(int(cand_bank[c]), 0)
        i = max(int(cand_row[c]), 0)
        fl = int(fresh_loc[b, i])
        slot = int(region_slot[i // rs_a])
        pr = max(slot, 0) * rs + i % rs_a
        # (score, action, payload) — ties resolve to the lowest action id,
        # which orders parity options before the redirect exactly as the
        # production builder's action stack does
        acts: List[Tuple[int, int, object]] = []
        if fl == 0:                                     # fresh value in bank
            if p.coalesce and (b, i) in syms:
                acts.append((0, MODE_FROM_SYM, None))
            if not port_busy[b]:
                acts.append((3, MODE_DIRECT, None))
            for k, (j, sibs) in enumerate(sys.options[b]):
                if slot < 0 or not parity_valid[j, pr]:
                    continue
                if port_busy[sch.par_port(j)]:
                    continue
                need = [s for s in sibs if (s, i) not in syms]
                if any(port_busy[s] for s in need):
                    continue
                acts.append((2 * (1 + len(need)), MODE_OPT0 + k, (j, need)))
        else:                                           # parked in parity fl-1
            hp = sch.par_port(fl - 1)
            if not port_busy[hp]:
                acts.append((2, MODE_REDIRECT, hp))
        if not acts:
            continue
        _, act, payload = min(acts, key=lambda a: (a[0], a[1]))
        served[c] = True
        mode[c] = act
        if act == MODE_DIRECT:
            port_busy[b] = True
            syms.add((b, i))
        elif act == MODE_REDIRECT:
            port_busy[payload] = True
        elif act >= MODE_OPT0:
            j, need = payload
            port_busy[sch.par_port(j)] = True
            for s in need:
                port_busy[s] = True
                syms.add((s, i))
            syms.add((b, i))
        # MODE_FROM_SYM is free: no ports, row already materialized
    port_busy[sch.n_ports] = True       # the builders' no-op sink slot
    n_served = int(served.sum())
    n_degraded = int((served & ((mode == MODE_FROM_SYM)
                                | ((mode >= MODE_OPT0)
                                   & (mode < MODE_REDIRECT)))).sum())
    return OracleReadPlan(served, mode, port_busy, n_served, n_degraded)


def _rc_push(rc_bank, rc_row, rc_valid, b: int, i: int) -> bool:
    """Queue (b, i) for recoding unless already pending; False = ring full."""
    if bool((rc_valid & (rc_bank == b) & (rc_row == i)).any()):
        return True
    free = np.flatnonzero(~rc_valid)
    if free.size == 0:
        return False
    k = int(free[0])
    rc_bank[k] = b
    rc_row[k] = i
    rc_valid[k] = True
    return True


def build_write_plan(sys: "OracleMemorySystem", cand_bank, cand_row, cand_age,
                     cand_valid, port_busy, fresh_loc, parity_valid,
                     region_slot, parked_count, rc_bank, rc_row, rc_valid,
                     rs_active: Optional[int] = None,
                     down=None) -> OracleWritePlan:
    """Greedy oldest-first write matcher (paper Fig 14 / §IV-C).

    ``down`` (fault injection): currently-down data banks. A candidate is
    *sticky* when its own bank is down or a covering parity has a down
    member — its park stays parked (no recode request) until the rebuild
    sweep drains it, and scoring prefers (a) normal parks, (b) parks into
    all-alive parities, (c) parks into down-covering parities, (d) a direct
    write, strictly last for a sticky-but-alive bank. Sticky parks waive
    the recode-space requirement. Mirrors the production builder's
    degraded-write mode (``repro_torch.core.controller``)."""
    p, sch = sys.p, sys.scheme
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    n = len(cand_bank)
    port_busy = np.array(port_busy, bool)
    fresh_loc = np.array(fresh_loc, np.int32)
    parity_valid = np.array(parity_valid, bool)
    parked_count = np.array(parked_count, np.int32)
    rc_bank = np.array(rc_bank, np.int32)
    rc_row = np.array(rc_row, np.int32)
    rc_valid = np.array(rc_valid, bool)
    served = np.zeros(n, bool)
    mode = np.full(n, WMODE_UNSERVED, np.int32)
    dropped = 0
    for c in _stable_age_order(cand_age, cand_valid):
        if not cand_valid[c]:
            continue
        b = max(int(cand_bank[c]), 0)
        i = max(int(cand_row[c]), 0)
        region = i // rs_a
        slot = int(region_slot[region])
        coded = slot >= 0
        pr = max(slot, 0) * rs + i % rs_a
        fl = int(fresh_loc[b, i])
        rc_space = bool((~rc_valid).any())
        sticky = False
        if down is not None:
            sticky = bool(down[b]) or (coded and any(
                any(down[m] for m in sch.members[j] if m != b)
                for j, _s in sys.options[b]))
        acts: List[Tuple[int, int, int]] = []
        if not port_busy[b]:
            acts.append((2 + 2 * MAX_OPTS + 2 if sticky else 1,
                         WMODE_DIRECT, -1))
        for k, (j, _sibs) in enumerate(sys.options[b]):
            # park the raw value into parity j's row: region coded, parity
            # port free, the row slot not held by ANOTHER member's parked
            # value, and recode space so it can always drain back (sticky
            # parks don't enqueue, so they waive the space requirement)
            if not coded or port_busy[sch.par_port(j)]:
                continue
            if not (rc_space or sticky):
                continue
            if any(fresh_loc[m, i] == j + 1
                   for m in sch.members[j] if m != b):
                continue
            shift = 0
            if down is not None and any(down[m] for m in sch.members[j]
                                        if m != b):
                shift = MAX_OPTS + 2
            acts.append((2 + k + shift, WMODE_PARK0 + k, j))
        if not acts:
            continue
        _, act, j_sel = min(acts, key=lambda a: (a[0], a[1]))
        served[c] = True
        mode[c] = act
        was_parked = fl > 0
        if act == WMODE_DIRECT:
            port_busy[b] = True
            fresh_loc[b, i] = 0
            if was_parked:
                parked_count[region] -= 1
            if coded:                  # every covering parity goes stale
                for j, _ in sys.options[b]:
                    parity_valid[j, pr] = False
            need_rc = coded and len(sys.options[b]) > 0
        else:
            port_busy[sch.par_port(j_sel)] = True
            fresh_loc[b, i] = j_sel + 1
            if not was_parked:
                parked_count[region] += 1
            parity_valid[j_sel, pr] = False
            # a sticky park stays parked: the rebuild sweep enqueues it
            # once its down parity-group member is recovering
            need_rc = not sticky
        if need_rc and not _rc_push(rc_bank, rc_row, rc_valid, b, i):
            dropped += 1
    port_busy[sch.n_ports] = True
    n_served = int(served.sum())
    n_parked = int((served & (mode >= WMODE_PARK0)).sum())
    return OracleWritePlan(served, mode, port_busy, fresh_loc, parity_valid,
                           parked_count, rc_bank, rc_row, rc_valid, n_served,
                           n_parked, dropped)


def recode_step(sys: "OracleMemorySystem", port_busy, fresh_loc, parity_valid,
                parked_count, rc_bank, rc_row, rc_valid, region_slot,
                banks_data, parity_data,
                rs_active: Optional[int] = None,
                down=None) -> OracleRecodeOut:
    """Sequential ring scan retiring ≤ ``recode_budget`` entries (§IV-D).

    ``down`` (fault injection): *hard-down* data banks. A recompute that
    would read a hard-down member is blocked (invalidated instead of
    recomputed on a parked retire); entries whose own bank is hard-down
    are moot and dropped — the rebuild sweep re-enqueues them on recovery.
    Mirrors ``repro_torch.core.recoding``."""
    p, sch = sys.p, sys.scheme
    rs = p.region_size
    rs_a = rs if rs_active is None else int(rs_active)
    port_busy = np.array(port_busy, bool)
    fresh_loc = np.array(fresh_loc, np.int32)
    parity_valid = np.array(parity_valid, bool)
    parked_count = np.array(parked_count, np.int32)
    rc_valid = np.array(rc_valid, bool)
    banks_data = np.array(banks_data, np.int32)
    parity_data = np.array(parity_data, np.int32)
    budget = p.recode_budget
    for e in range(p.recode_cap):
        if budget <= 0:
            break
        if not rc_valid[e]:
            continue
        b = max(int(rc_bank[e]), 0)
        i = max(int(rc_row[e]), 0)
        region = i // rs_a
        slot = int(region_slot[region])
        coded = slot >= 0
        pr = max(slot, 0) * rs + i % rs_a
        fl = int(fresh_loc[b, i])
        parked = fl > 0
        # stale covering parities need recomputation — and when (b, i) is
        # parked, ALL covering parities do (restoring changes the bank row
        # under them). A parity holding ANOTHER member's parked value is
        # blocked: recomputing would destroy that value; that member's own
        # entry restores it first. Blocked parities are invalidated instead
        # when this restore changed the bank value.
        recompute: List[int] = []
        blocked_l: List[int] = []
        if coded:
            for j, _sibs in sys.options[b]:
                blocked = any(fresh_loc[m, i] == j + 1
                              for m in sch.members[j] if m != b)
                if down is not None:
                    blocked = blocked or any(down[m] for m in sch.members[j]
                                             if m != b)
                if not parity_valid[j, pr] or parked:
                    (blocked_l if blocked else recompute).append(j)
        self_down = down is not None and bool(down[b])
        if not coded or not (parked or recompute) or self_down:
            rc_valid[e] = False                       # moot: nothing to do
            continue
        needed = {b}
        if parked:
            needed.add(sch.par_port(fl - 1))
        for j in recompute:
            needed.add(sch.par_port(j))
            needed.update(sch.members[j])
        if any(port_busy[x] for x in needed):
            continue                                  # stays pending
        for x in needed:
            port_busy[x] = True
        if parked:
            banks_data[b, i] = parity_data[fl - 1, pr]
            parked_count[region] -= 1
        fresh_loc[b, i] = 0
        for j in recompute:
            val = 0
            for m in sch.members[j]:
                val ^= int(banks_data[m, i])
            parity_data[j, pr] = np.int32(val)
            parity_valid[j, pr] = True
        if parked:
            for j in blocked_l:
                parity_valid[j, pr] = False
        rc_valid[e] = False
        budget -= 1
    return OracleRecodeOut(port_busy, fresh_loc, parity_valid, parked_count,
                           rc_valid, banks_data, parity_data,
                           p.recode_budget - budget)


class OracleMemorySystem:
    """The golden model: an independent, sequential coded memory system."""

    def __init__(self, scheme: Union[str, OracleScheme], params: OracleParams,
                 n_cores: int = 8):
        self.scheme = (oracle_scheme(scheme, params.n_data)
                       if isinstance(scheme, str) else scheme)
        # hysteresis sanity: thresholds clamp into the queue and must not
        # cross (lo > hi would flap write mode every cycle); chained-decode
        # reuse is meaningless without parities
        hi = min(params.wq_hi, params.queue_depth - 1)
        params = dataclasses.replace(
            params, wq_hi=hi, wq_lo=min(params.wq_lo, hi),
            select_period=max(params.select_period, 1),
            coalesce=params.coalesce and self.scheme.n_parities > 0)
        self.p = params
        self.n_cores = n_cores
        # per-bank serving options, resolved once
        self.options = [self.scheme.options(b) for b in range(params.n_data)]

    # ------------------------------------------------------------------ init
    def init_state(self, region_priors=None, fault_plan=None) -> OracleState:
        p = self.p
        if fault_plan is not None and not p.faults:
            raise ValueError("fault_plan given but OracleParams.faults off")
        n_par = max(self.scheme.n_parities, 1)
        n_slot_rows = p.n_slots * p.region_size
        rs_a, nr_a = p.rs_active, p.nr_active
        if p.n_active >= p.n_regions:
            # static full coverage: identity map over the point's own
            # regions; active parity rows valid (all banks zero at init)
            rid = np.arange(p.n_regions, dtype=np.int32)
            region_slot = np.where(rid < nr_a, rid, -1).astype(np.int32)
            sid = np.arange(p.n_slots, dtype=np.int32)
            slot_region = np.where(sid < nr_a, sid, -1).astype(np.int32)
            row = np.arange(n_slot_rows)
            active = (row // p.region_size < nr_a) & (row % p.region_size < rs_a)
            parity_valid = np.broadcast_to(active, (n_par, n_slot_rows)).copy()
        elif region_priors is not None:
            region_slot, slot_region, parity_valid = self._priors_layout(
                region_priors, n_par, n_slot_rows)
        else:
            region_slot = np.full(p.n_regions, -1, np.int32)
            slot_region = np.full(p.n_slots, -1, np.int32)
            parity_valid = np.zeros((n_par, n_slot_rows), bool)
        return OracleState(
            fresh_loc=np.zeros((p.n_data, p.n_rows), np.int32),
            parity_valid=parity_valid,
            region_slot=region_slot,
            slot_region=slot_region,
            access_count=np.zeros(p.n_regions, np.int32),
            parked_count=np.zeros(p.n_regions, np.int32),
            enc_region=-1, enc_remaining=0, enc_slot=-1, switches=0,
            rc_bank=np.full(p.recode_cap, -1, np.int32),
            rc_row=np.full(p.recode_cap, -1, np.int32),
            rc_valid=np.zeros(p.recode_cap, bool),
            rq_row=np.full((p.n_data, p.queue_depth), -1, np.int32),
            rq_age=np.full((p.n_data, p.queue_depth), INT32_MAX, np.int32),
            rq_valid=np.zeros((p.n_data, p.queue_depth), bool),
            wq_row=np.full((p.n_data, p.queue_depth), -1, np.int32),
            wq_age=np.full((p.n_data, p.queue_depth), INT32_MAX, np.int32),
            wq_valid=np.zeros((p.n_data, p.queue_depth), bool),
            wq_data=np.zeros((p.n_data, p.queue_depth), np.int32),
            write_mode=False, cycle=0,
            banks_data=np.zeros((p.n_data, p.n_rows), np.int32),
            parity_data=np.zeros((n_par, n_slot_rows), np.int32),
            golden=np.zeros((p.n_data, p.n_rows), np.int32),
            served_reads=0, served_writes=0, degraded_reads=0,
            parked_writes=0, read_latency_sum=0, write_latency_sum=0,
            stall_cycles=0, rc_dropped=0,
            core_ptr=np.zeros(self.n_cores, np.int32),
            done_cycle=-1,
            tele=(_init_oracle_telemetry(p.n_data, self.n_cores,
                                         p.queue_depth)
                  if p.telemetry else None),
            fault=(_init_oracle_fault(p.n_data, self.scheme.n_ports,
                                      fault_plan)
                   if p.faults else None),
        )

    def _priors_layout(self, priors, n_par: int, n_slot_rows: int):
        """Warm start: ranked distinct hot regions pre-mapped into slots 0..
        up to the point's budget; out-of-range / -1 entries skipped without
        shifting later entries into their slots (the zeroed parity rows are
        the true XOR of the all-zero banks, so they start valid)."""
        p = self.p
        pr = np.asarray(priors, np.int32).reshape(-1)
        rs = p.region_size
        region_slot = np.full(p.n_regions, -1, np.int32)
        slot_region = np.full(p.n_slots, -1, np.int32)
        parity_valid = np.zeros((n_par, n_slot_rows), bool)
        budget = p.slot_budget
        for sid in range(min(pr.size, p.n_slots)):
            cand = int(pr[sid])
            if sid >= budget or cand < 0 or cand >= p.nr_active:
                continue
            slot_region[sid] = cand
            region_slot[cand] = sid
            parity_valid[:, sid * rs: sid * rs + p.rs_active] = True
        return region_slot, slot_region, parity_valid

    # --------------------------------------------------------------- arbiter
    def _arbiter(self, st: OracleState, trace, stream_end):
        """Cores in index order push into their destination queue."""
        p = self.p
        bank, row, is_write, data, valid = trace
        tlen = bank.shape[1]
        rs_a = p.rs_active
        for c in range(self.n_cores):
            pos = int(st.core_ptr[c])
            end = tlen if stream_end is None else int(stream_end[c])
            in_range = pos < end
            pc = min(pos, tlen - 1)
            v = bool(valid[c, pc]) and in_range
            if not v:
                if in_range:
                    st.core_ptr[c] = pos + 1          # idle slot: consume it
                continue
            b = max(int(bank[c, pc]), 0)
            i = max(int(row[c, pc]), 0)
            w = bool(is_write[c, pc])
            if w:
                q_valid, q_row, q_age = st.wq_valid, st.wq_row, st.wq_age
            else:
                q_valid, q_row, q_age = st.rq_valid, st.rq_row, st.rq_age
            free = np.flatnonzero(~q_valid[b])
            if free.size == 0:
                st.stall_cycles += 1                  # full queue: stall
                if st.tele is not None:
                    st.tele.stall_cause[b, 1 if w else 0] += 1
                continue
            s = int(free[0])
            q_row[b, s] = i
            q_age[b, s] = st.cycle
            q_valid[b, s] = True
            if st.tele is not None:
                (st.tele.wq_core if w else st.tele.rq_core)[b, s] = c
            if w:
                st.wq_data[b, s] = data[c, pc]
            region = i // rs_a
            if region < p.n_regions:
                st.access_count[region] += 1
            st.core_ptr[c] = pos + 1

    # -------------------------------------------------------------- datapath
    def _read_value(self, st: OracleState, b: int, i: int, mode: int) -> int:
        """Value a served read returns (direct / XOR-decode / redirect)."""
        p = self.p
        rs, rs_a = p.region_size, p.rs_active
        slot = int(st.region_slot[i // rs_a])
        pr = max(slot, 0) * rs + i % rs_a
        if mode == MODE_REDIRECT:
            holder = max(int(st.fresh_loc[b, i]) - 1, 0)
            return int(st.parity_data[holder, pr])
        if MODE_OPT0 <= mode < MODE_REDIRECT:
            j, sibs = self.options[b][mode - MODE_OPT0]
            val = int(st.parity_data[j, pr])
            for s in sibs:
                val ^= int(st.banks_data[s, i])
            return val
        return int(st.banks_data[b, i])               # direct / from-symbol

    def _commit_writes(self, st: OracleState, plan: OracleWritePlan,
                       cb, ci, ca, cv, cd):
        """Oldest-first commit: the youngest served write to a cell wins."""
        p = self.p
        rs, rs_a = p.region_size, p.rs_active
        for c in _stable_age_order(ca, cv):
            if not plan.served[c]:
                continue
            b = max(int(cb[c]), 0)
            i = max(int(ci[c]), 0)
            m = int(plan.mode[c])
            if m == WMODE_DIRECT:
                st.banks_data[b, i] = cd[c]
            else:
                slot = int(st.region_slot[i // rs_a])
                pr = max(slot, 0) * rs + i % rs_a
                j, _ = self.options[b][m - WMODE_PARK0]
                st.parity_data[j, pr] = cd[c]
            st.golden[b, i] = cd[c]

    # --------------------------------------------------------------- dynamic
    def _dynamic_step(self, st: OracleState, quiesce: bool):
        p, sch = self.p, self.scheme
        if p.n_active >= p.n_regions:                 # statically full: off
            return
        rs, rs_a, nr_a = p.region_size, p.rs_active, p.nr_active
        n_par = max(sch.n_parities, 1)
        # ---- in-flight encode countdown / completion
        in_flight = st.enc_region >= 0
        st.enc_remaining = st.enc_remaining - 1 if in_flight else 0
        if in_flight and st.enc_remaining <= 0:
            region, slot = st.enc_region, st.enc_slot
            for off in range(rs):
                i = min(max(region * rs_a + off, 0), p.n_rows - 1)
                for j in range(n_par):
                    val = 0
                    if off < rs_a and j < sch.n_parities:
                        for m in sch.members[j]:
                            val ^= int(st.banks_data[m, i])
                    st.parity_data[j, slot * rs + off] = np.int32(val)
                if off < rs_a:
                    st.parity_valid[:, slot * rs + off] = True
            st.region_slot[region] = slot
            st.slot_region[slot] = region
            st.switches += 1
            st.enc_region = -1
            st.enc_slot = -1
        # ---- periodic selection (skipped once the workload has drained)
        period = st.cycle > 0 and st.cycle % p.select_period == 0
        if period and st.enc_region < 0 and not quiesce:
            coded = st.region_slot >= 0
            active = np.arange(p.n_regions) < nr_a
            cand_counts = np.where(coded | ~active, -1, st.access_count)
            cand = int(np.argmax(cand_counts))
            cand_count = int(cand_counts[cand])
            evict_counts = np.where(coded & (st.parked_count == 0),
                                    st.access_count, INT32_MAX)
            victim = int(np.argmin(evict_counts))
            victim_count = int(evict_counts[victim])
            budget = p.slot_budget
            free = [s for s in range(min(p.n_slots, budget))
                    if st.slot_region[s] < 0]
            start_free = bool(free) and cand_count > 0
            start_evict = (not free and cand_count > victim_count
                           and victim_count < INT32_MAX)
            if start_evict:
                vslot = max(int(st.region_slot[victim]), 0)
                st.parity_valid[:, vslot * rs: (vslot + 1) * rs] = False
                st.region_slot[victim] = -1
                st.slot_region[vslot] = -1
            if start_free or start_evict:
                st.enc_region = cand
                st.enc_slot = vslot if start_evict else free[0]
                st.enc_remaining = max(1, rs_a // p.encode_rows_per_cycle)
        if period:
            st.access_count //= 2

    # ------------------------------------------------------------- one cycle
    def cycle(self, st: OracleState, trace, stream_end=None) -> OracleCycleOut:
        p = self.p
        rs_a = p.rs_active
        was_done = st.done_cycle >= 0
        self._arbiter(st, trace, stream_end)
        if st.tele is not None:
            np.maximum(st.tele.rq_hwm, st.rq_valid.sum(axis=1),
                       out=st.tele.rq_hwm)
            np.maximum(st.tele.wq_hwm, st.wq_valid.sum(axis=1),
                       out=st.tele.wq_hwm)

        # ---- fault injection: this cycle's predicates, dead-cycle counts,
        # fail-fast drops of unservable queue entries (mirrors the
        # production hook order exactly: after the arbiter + HWM, before
        # the hysteresis reads queue occupancy — repro_torch.faults.inject)
        down = rebuilding = down_hard = stut = None
        fs = st.fault
        if p.faults:
            cyc = st.cycle
            down = (fs.fail_at <= cyc) & ~fs.rebuilt
            rebuilding = down & (fs.recover_at <= cyc)
            down_hard = down & ~rebuilding
            per = fs.stutter_period
            stut = (per > 0) & (cyc % np.maximum(per, 1) == fs.stutter_phase)
            if not was_done:   # counted until the workload drains
                fs.dead_cycles += down.astype(np.int64)
                if st.tele is not None:
                    st.tele.dead_cycles += down.astype(np.int64)
            for b in range(p.n_data):
                if not down_hard[b]:
                    continue
                for s in range(p.queue_depth):
                    if st.rq_valid[b, s]:
                        i = max(int(st.rq_row[b, s]), 0)
                        slot = int(st.region_slot[i // rs_a])
                        pr = max(slot, 0) * p.region_size + i % rs_a
                        viable = slot >= 0 and any(
                            st.parity_valid[j, pr]
                            and not any(down_hard[x] for x in sibs)
                            for j, sibs in self.options[b])
                        if int(st.fresh_loc[b, i]) == 0 and not viable:
                            st.rq_valid[b, s] = False
                            fs.unserved_reads += 1
                    if st.wq_valid[b, s]:
                        i = max(int(st.wq_row[b, s]), 0)
                        coded = int(st.region_slot[i // rs_a]) >= 0
                        if not coded or not self.options[b]:
                            st.wq_valid[b, s] = False
                            fs.lost_writes += 1

        # write-drain hysteresis
        wq_occ = int(st.wq_valid.sum(axis=1).max())
        any_r = bool(st.rq_valid.any())
        any_w = bool(st.wq_valid.any())
        wm = (wq_occ > p.wq_lo) if st.write_mode else (wq_occ >= p.wq_hi)
        serve_writes = (wm or (not any_r and any_w)) and any_w

        n = p.n_data * p.queue_depth
        bank_ids = np.repeat(np.arange(p.n_data, dtype=np.int32),
                             p.queue_depth)
        port_busy0 = np.zeros(self.scheme.n_ports + 1, bool)
        if p.faults:
            # a down bank's port reads permanently busy to both builders;
            # stuttering ports transiently so
            port_busy0[: p.n_data] |= down
            port_busy0[: self.scheme.n_ports] |= stut
        if serve_writes:
            cb, ci = bank_ids, st.wq_row.reshape(-1)
            ca, cv = st.wq_age.reshape(-1), st.wq_valid.reshape(-1)
            cd = st.wq_data.reshape(-1)
            plan = build_write_plan(
                self, cb, ci, ca, cv, port_busy0, st.fresh_loc,
                st.parity_valid, st.region_slot, st.parked_count,
                st.rc_bank, st.rc_row, st.rc_valid, rs_a, down=down)
            self._commit_writes(st, plan, cb, ci, ca, cv, cd)
            lat = int(np.where(plan.served, st.cycle - ca, 0).sum())
            if st.tele is not None:
                te = st.tele
                for c in range(n):
                    if plan.served[c]:
                        core = int(te.wq_core[c // p.queue_depth,
                                              c % p.queue_depth])
                        cls = 0 if int(plan.mode[c]) == WMODE_DIRECT else 1
                        te.write_mode_core[core, cls] += 1
                        te.lat_hist_write[_lat_bin(st.cycle - int(ca[c]))] += 1
                    elif cv[c]:           # valid but unserved: a wait cycle
                        te.wait_cause[int(cb[c]), 1] += 1
            st.wq_valid &= ~plan.served.reshape(p.n_data, p.queue_depth)
            st.fresh_loc = plan.fresh_loc
            st.parity_valid = plan.parity_valid
            st.parked_count = plan.parked_count
            st.rc_bank, st.rc_row, st.rc_valid = (plan.rc_bank, plan.rc_row,
                                                  plan.rc_valid)
            st.served_writes += plan.n_served
            st.parked_writes += plan.n_parked
            st.rc_dropped += plan.n_rc_dropped
            st.write_latency_sum += lat
            port_busy = plan.port_busy
            out = OracleCycleOut(np.zeros(n, bool), cb, ci,
                                 np.zeros(n, np.int32), plan.n_served)
        else:
            cb, ci = bank_ids, st.rq_row.reshape(-1)
            ca, cv = st.rq_age.reshape(-1), st.rq_valid.reshape(-1)
            plan = build_read_plan(
                self, cb, ci, ca, cv, port_busy0, st.fresh_loc,
                st.parity_valid, st.region_slot, rs_a)
            vals = np.zeros(n, np.int32)
            for c in np.flatnonzero(plan.served):
                vals[c] = self._read_value(st, max(int(cb[c]), 0),
                                           max(int(ci[c]), 0),
                                           int(plan.mode[c]))
            lat = int(np.where(plan.served, st.cycle - ca, 0).sum())
            if p.faults:
                # reads served degraded *because* their bank is down (a
                # redirect to a parked copy is a freshness artifact, not a
                # fault symptom)
                for c in np.flatnonzero(plan.served):
                    m = int(plan.mode[c])
                    if down[max(int(cb[c]), 0)] and (
                            m == MODE_FROM_SYM
                            or MODE_OPT0 <= m < MODE_REDIRECT):
                        fs.fault_degraded += 1
            if st.tele is not None:
                te = st.tele
                for c in range(n):
                    m = int(plan.mode[c])
                    if plan.served[c]:
                        core = int(te.rq_core[c // p.queue_depth,
                                              c % p.queue_depth])
                        cls = (0 if m == MODE_DIRECT else
                               1 if m == MODE_FROM_SYM else
                               3 if m >= MODE_REDIRECT else 2)
                        if (p.faults and cls in (1, 2)
                                and down[max(int(cb[c]), 0)]):
                            cls = 4
                        te.read_mode_core[core, cls] += 1
                        te.lat_hist_read[_lat_bin(st.cycle - int(ca[c]))] += 1
                    elif cv[c]:
                        te.wait_cause[int(cb[c]), 0] += 1
            st.rq_valid &= ~plan.served.reshape(p.n_data, p.queue_depth)
            st.served_reads += plan.n_served
            st.degraded_reads += plan.n_degraded
            st.read_latency_sum += lat
            port_busy = plan.port_busy
            out = OracleCycleOut(plan.served, cb, ci, vals, plan.n_served)
        st.write_mode = wm

        # recoding unit uses the cycle's leftover ports. A REBUILDING
        # bank's port is granted back to it here (and only here); stutter
        # still applies.
        if p.faults:
            rc_pb = np.array(port_busy, bool)
            rc_pb[: p.n_data] = np.where(rebuilding, stut[: p.n_data],
                                         port_busy[: p.n_data])
        else:
            rc_pb = port_busy
        rc = recode_step(self, rc_pb, st.fresh_loc, st.parity_valid,
                         st.parked_count, st.rc_bank, st.rc_row, st.rc_valid,
                         st.region_slot, st.banks_data, st.parity_data, rs_a,
                         down=down_hard)
        st.fresh_loc, st.parity_valid = rc.fresh_loc, rc.parity_valid
        st.parked_count, st.rc_valid = rc.parked_count, rc.rc_valid
        st.banks_data, st.parity_data = rc.banks_data, rc.parity_data
        if st.tele is not None:
            st.tele.recode_retired += rc.n_recoded
            for e in np.flatnonzero(st.rc_valid):     # still pending: waits
                st.tele.wait_cause[max(int(st.rc_bank[e]), 0), 2] += 1

        # online rebuild: a flat cursor sweeps every (bank, row) cell at
        # recode_budget cells per cycle while any bank is rebuilding,
        # pushing cells parked elsewhere or with a stale covering parity
        # into the recode ring; ``rebuilt`` latches — the bank rejoins —
        # when the sweep is done, the ring drained, and no parked cell
        # remains on a bank that is not still hard-down. Mirrors
        # ``repro_torch.faults.inject.rebuild_scan``.
        if p.faults:
            total = p.n_data * p.n_rows
            any_rb = bool(rebuilding.any())
            newly = bool(((fs.recover_at == st.cycle)
                          & (fs.fail_at <= st.cycle) & ~fs.rebuilt).any())
            ptr = 0 if newly else int(fs.rebuild_ptr)
            for _ in range(p.recode_budget):
                cell = min(ptr, total - 1)
                x, i = cell // p.n_rows, cell % p.n_rows
                in_range = any_rb and ptr < total
                region = i // rs_a
                in_geom = region < p.nr_active
                slot = int(st.region_slot[min(region, p.n_regions - 1)])
                pr = max(slot, 0) * p.region_size + i % rs_a
                stale = slot >= 0 and any(not st.parity_valid[j, pr]
                                          for j, _s in self.options[x])
                need = in_range and in_geom and (
                    int(st.fresh_loc[x, i]) > 0 or stale)
                ok = True
                if need:
                    ok = _rc_push(st.rc_bank, st.rc_row, st.rc_valid, x, i)
                if in_range and (not need or ok):
                    ptr += 1
            fs.rebuild_ptr = ptr
            pending_park = bool(((st.fresh_loc > 0).any(axis=1)
                                 & ~down_hard).any())
            if ptr >= total and not st.rc_valid.any() and not pending_park:
                fs.rebuilt |= rebuilding

        # dynamic coding unit
        self._dynamic_step(st, quiesce=was_done)

        # completion bookkeeping
        tlen = trace[0].shape[1]
        ends = (np.full(self.n_cores, tlen) if stream_end is None
                else np.asarray(stream_end))
        consumed = bool((st.core_ptr >= ends).all())
        drained = not st.rq_valid.any() and not st.wq_valid.any()
        if st.done_cycle < 0 and consumed and drained:
            st.done_cycle = st.cycle
        st.cycle += 1
        return out

    # ------------------------------------------------------------------- run
    def quiescent(self, st: OracleState) -> bool:
        """Observable fixed point: workload drained, encoder idle, recode
        ring empty — every further cycle is an observable no-op. With
        faults on, also no scheduled fault event (a pending failure, or a
        failure with a recovery whose rebuild hasn't completed) that could
        still change observable state."""
        q = (st.done_cycle >= 0 and st.enc_region < 0
             and not st.rc_valid.any())
        if q and st.fault is not None:
            fs, cyc = st.fault, st.cycle
            down = (fs.fail_at <= cyc) & ~fs.rebuilt
            pending = (((fs.fail_at > cyc) & (fs.fail_at < INT32_MAX))
                       | (down & (fs.recover_at < INT32_MAX)))
            q = not bool(pending.any())
        return q

    def run(self, trace, n_cycles: int, st: Optional[OracleState] = None,
            stream_end=None, stop_when_quiescent: bool = False
            ) -> OracleState:
        """Advance ``n_cycles`` over a (n_cores, T) trace.

        ``stop_when_quiescent`` cuts the trailing no-op cycles (what the
        production sweep engine's early exit does); leave it off when the
        final *state* — including the free-running cycle counter and the
        windowed access-count decay — must match a fixed-length run."""
        if st is None:
            st = self.init_state()
        trace = tuple(np.asarray(x) for x in trace)
        for _ in range(n_cycles):
            if stop_when_quiescent and self.quiescent(st):
                break
            self.cycle(st, trace, stream_end)
        return st

    def result(self, st: OracleState) -> OracleResult:
        sr, sw = st.served_reads, st.served_writes
        return OracleResult(
            cycles=st.done_cycle if st.done_cycle >= 0 else st.cycle,
            completed=st.done_cycle >= 0,
            served_reads=sr,
            served_writes=sw,
            degraded_reads=st.degraded_reads,
            parked_writes=st.parked_writes,
            switches=st.switches,
            recode_backlog=int(st.rc_valid.sum()),
            stall_cycles=st.stall_cycles,
            avg_read_latency=st.read_latency_sum / max(sr, 1),
            avg_write_latency=st.write_latency_sum / max(sw, 1),
            rc_dropped=st.rc_dropped,
            unserved_reads=(st.fault.unserved_reads
                            if st.fault is not None else 0),
            lost_writes=(st.fault.lost_writes
                         if st.fault is not None else 0),
            fault_degraded_reads=(st.fault.fault_degraded
                                  if st.fault is not None else 0),
            dead_bank_cycles=(int(st.fault.dead_cycles.sum())
                              if st.fault is not None else 0),
        )
