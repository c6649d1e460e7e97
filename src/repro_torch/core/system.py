"""The coded memory system: core arbiter + bank queues + access scheduler.
Port of ``repro/core/system.py``.

One ``cycle_fn`` call is one memory clock cycle (paper Fig 2 / §IV):

  1. core arbiter — each core's pending request enters its bank's read or
     write queue; a full queue stalls the core;
  2. access scheduler — the write-drain hysteresis picks read or write
     mode and that side's pattern builder schedules the cycle;
  3. datapath — served reads return values (direct / XOR decode /
     redirect) through the ``xor_gather`` kernel; served writes commit to
     data banks or park in parity rows; ``golden`` tracks memory order;
  4. ReCoding unit; 5. dynamic coding unit (region encodes through the
     ``xor_encode`` kernel).

The point axis. ``cycle_batch`` advances B points lock-step: every state
leaf and trace field has a leading (B,) axis and the tunables are batched
(``state.batch_tunables``), where JAX ``vmap``s ``cycle_fn``. A batched
cycle makes about the launches of one point's cycle, whatever B is: one
``xor_gather`` launch serves every point's reads and one ``xor_encode``
launch every region encode. ``cycle_fn``, ``run``, ``run_chunk`` and
``init`` are one point's: the batched code on a batch of one.

``run`` executes exactly ``n_cycles`` cycles, as JAX's ``lax.scan`` does,
so final states compare leaf for leaf. ``run_chunk_batch`` advances B
points over one staged chunk (or a whole trace) and leaves its loop early
(one point starved, every point quiescent, or out of budget), as JAX's
``lax.while_loop`` does: the device half of the sweep engine
(``repro_torch.sweep``) and of streamed replay (``repro_torch.traces``).

Eager execution, and how it stays bit-identical to JAX: JAX runs both
builders every cycle (the off-duty one on masked-invalid candidates) and
selects per point, for ``vmap``'s sake; here one host read of the batch's
``serve_writes`` picks the branches. When every point writes only the
write builder runs, when every point reads only the read builder, and
when they disagree both run on masked candidates and each point takes
its own branch's result, as JAX does. Each branch sees exactly the
candidates JAX's would, so the results are the same (and a batch of one
runs one branch). Scatters that JAX does with ``mode="drop"`` go through
flat buffers with one trailing sink entry that is sliced off
(``_set_flat``); scatters with duplicate indices only ever write one value
per cell apart from the sink, and JAX's accumulating ``.add`` scatters
become one ``scatter_add_`` (``_add_ones``).

Fault injection (``make_params(faults=True)``, ``repro_torch.faults``):
the ``fault`` leaf carries each point's schedule, so one batch runs
points with different plans. Each cycle derives the down, rebuilding and
stuttering masks per point, fail-fast-drops unservable requests, seeds
the builders' busy ports, counts fault-degraded reads, blocks recomputes
on hard-down members and advances the rebuild sweep, as JAX's cycle
does. With the flag off none of it runs.

Telemetry (``make_params(telemetry=True)``, ``repro_torch.obs.planes``):
the ``tele`` leaf's planes are updated where JAX's cycle updates them:
stall causes and the queue slots' core ids in the arbiter, the queue
high-water marks after it, dead-bank cycles in the fault block, each
branch's provenance classes (class 4 for reads degraded because their
bank is down), latency histograms and wait causes, and the recode unit's
retirements and pending entries. A branch run on masked candidates counts
nothing for the points it is masked for, and ``_pick`` keeps each point's
own branch's planes, as JAX's ``pick`` does. With the flag off none of it
runs.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.core import controller as ctl
from repro_torch.core.codes import MAX_OPTS, CodeTables
from repro_torch.core.controller import add_offset, col, point_offsets
from repro_torch.core.dynamic import dynamic_step
from repro_torch.core.recoding import recode_steps
from repro_torch.core.state import (INT32_MAX, MemParams, MemState,
                                    TunableParams, active_geometry,
                                    batch_of_one, batch_tunables,
                                    fault_states,
                                    init_states, make_tunables, point_of)
from repro_torch.faults import inject as finject
from repro_torch.faults import plan as fplan
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import planes as obs
# The module, not its names: the gather's ops import ``codes``, ``controller``
# and ``state``, so either package may be imported first.
from repro_torch.kernels.xor_gather import ops as gather_ops


class Trace(NamedTuple):
    """Per-core request streams. Invalid entries are idle cycles. A batch
    of B points' traces has a leading (B,) axis."""

    bank: torch.Tensor      # (n_cores, T) int32
    row: torch.Tensor       # (n_cores, T) int32
    is_write: torch.Tensor  # (n_cores, T) bool
    data: torch.Tensor      # (n_cores, T) int32 write payloads
    valid: torch.Tensor     # (n_cores, T) bool


def drain_bound(n_cores: int, length: int, backlog: int = 0) -> int:
    """Worst-case cycle budget to drain ``length`` requests per core (the
    JAX package's single shared bound; see its docstring for the
    derivation)."""
    return int((n_cores * length + backlog) * 1.5) + 64


class SimState(NamedTuple):
    mem: MemState
    core_ptr: torch.Tensor    # (n_cores,) int32
    done_cycle: torch.Tensor  # () int32, -1 until the workload drains


def quiescent(st: SimState) -> torch.Tensor:
    """Workload drained, encoder idle, recode ring empty: after it every
    cycle is an observable no-op, which makes every early exit equal to
    running the bound out. One point's 0-d flag, or (B,) for a batch.
    With faults on, a point is also not quiescent while a scheduled fault
    event can still change its state (``quiescent_fault_pending``)."""
    m = st.mem
    q = ((st.done_cycle >= 0) & (m.enc_region < 0)
         & ~m.rc_valid.any(-1))
    if m.fault is not None:
        q = q & ~finject.quiescent_fault_pending(m.fault, m.cycle)
    return q


class CycleOut(NamedTuple):
    """Per-cycle introspection (read datapath results)."""

    r_served: torch.Tensor  # (N,) bool
    r_bank: torch.Tensor    # (N,) int32
    r_row: torch.Tensor     # (N,) int32
    r_value: torch.Tensor   # (N,) int32
    n_served: torch.Tensor  # () int32 (reads+writes)


class SimResult(NamedTuple):
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
    unserved_reads: int = 0
    lost_writes: int = 0
    fault_degraded_reads: int = 0
    dead_bank_cycles: int = 0


def summarize_batch(st: SimState,
                    n_points: Optional[int] = None) -> List[SimResult]:
    """A batched SimState's per-point SimResults, with one device-to-host
    copy (``n_points`` keeps the first points only)."""
    m, f = st.mem, st.mem.fault
    cols = [st.done_cycle.long(), m.cycle.long(), m.served_reads.long(),
            m.served_writes.long(), m.degraded_reads.long(),
            m.parked_writes.long(), m.switches.long(), m.rc_valid.sum(-1),
            m.stall_cycles, m.read_latency_sum, m.write_latency_sum,
            m.rc_dropped.long()]
    if f is not None:
        cols += [f.unserved_reads.long(), f.lost_writes.long(),
                 f.fault_degraded.long(), f.dead_cycles.sum(-1)]
    rows = torch.stack(cols, 1)[:n_points].tolist()
    return [SimResult(
        cycles=dc if dc >= 0 else cyc, completed=dc >= 0,
        served_reads=sr, served_writes=sw, degraded_reads=deg,
        parked_writes=pw, switches=swi, recode_backlog=rc,
        stall_cycles=stall, avg_read_latency=rl / max(sr, 1),
        avg_write_latency=wl / max(sw, 1), rc_dropped=drop,
        **dict(zip(("unserved_reads", "lost_writes",
                    "fault_degraded_reads", "dead_bank_cycles"), rest)))
        for (dc, cyc, sr, sw, deg, pw, swi, rc, stall, rl, wl, drop, *rest)
        in rows]


def _pick(mask: torch.Tensor, x, y):
    """Per point, ``x`` where ``mask`` (B,) else ``y``, leaf by leaf (the
    same object passes through; None stays None)."""
    if x is y:
        return x
    if isinstance(x, tuple):
        leaves = (_pick(mask, a, b) for a, b in zip(x, y))
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    return torch.where(mask.view(-1, *[1] * (x.dim() - 1)), x, y)


def _set_flat(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x`` with ``x.flatten()[idx] = val`` (a new tensor), where an index
    equal to ``x.numel()`` is dropped (JAX's ``mode="drop"`` sink)."""
    buf = torch.cat([x.flatten(), x.new_zeros(1)])
    buf.index_put_((idx,), torch.as_tensor(val, dtype=x.dtype,
                                           device=x.device))
    return buf[:-1].view_as(x)


def _add_ones(planes, idxs):
    """Each tensor of ``planes`` with one added at ``plane.flatten()[i]``
    for every ``i`` of its index tensor in ``idxs`` (duplicates
    accumulate; the index ``plane.numel()`` is dropped): JAX's
    ``.at[...].add(1, mode="drop")``, one ``scatter_add_`` for all the
    planes (of one dtype), each followed by its own sink in the buffer."""
    zero = planes[0].new_zeros(1)
    bufs, parts, off = [], [], 0
    for x, idx in zip(planes, idxs):
        bufs += [x.flatten(), zero]
        parts.append(idx.flatten() + off if off else idx.flatten())
        off += x.numel() + 1
    buf = torch.cat(bufs)
    idx = torch.cat(parts)
    buf.scatter_add_(0, idx, buf.new_ones(()).expand_as(idx))
    out, off = [], 0
    for x in planes:
        out.append(buf[off:off + x.numel()].view_as(x))
        off += x.numel() + 1
    return out


class CodedMemorySystem:
    """Facade owning the static tables/params and the device."""

    def __init__(self, tables: CodeTables, params: MemParams,
                 n_cores: int = 8, tunables: Optional[TunableParams] = None,
                 device=None):
        self.tables = tables
        self.p = params
        self.device = resolve_device(device)
        self.t = ctl.jtables(tables, self.device)
        self.n_cores = n_cores
        self.tunables = (tunables if tunables is not None
                         else make_tunables(queue_depth=params.queue_depth))
        dev = self.device
        p = params
        self._bank_ids = torch.arange(p.n_data, dtype=torch.int32,
                                      device=dev).repeat_interleave(
                                          p.queue_depth)
        self._cores = torch.arange(n_cores, device=dev)
        self._older = torch.ones((n_cores, n_cores), dtype=torch.bool,
                                 device=dev).tril(-1)
        self._port_busy0 = {}
        if p.telemetry:
            # read provenance class by plan mode + 1: unserved (dropped),
            # from_sym 1, direct 0, each option 2, redirect 3
            self._read_class = torch.tensor(
                [2, 1, 0] + [2] * (ctl.MODE_REDIRECT - ctl.MODE_OPT0) + [3],
                dtype=torch.int64, device=dev)

    def _idle_ports(self, B: int) -> torch.Tensor:
        """(B, n_ports + 1) idle port mask (read only, kept per B)."""
        pb = self._port_busy0.get(B)
        if pb is None:
            pb = self._port_busy0[B] = torch.zeros(
                (B, self.p.n_ports + 1), dtype=torch.bool, device=self.device)
        return pb

    def batch_tunables(self, tn: Optional[TunableParams] = None
                       ) -> TunableParams:
        """One point's tunables (default the system's) as a batch of one."""
        return batch_tunables([tn if tn is not None else self.tunables],
                              self.device)

    # ------------------------------------------------------------------ init
    def init(self, tn: Optional[TunableParams] = None, region_priors=None,
             fault_plan=None) -> SimState:
        """One point's initial state (``init_batch`` on a batch of one;
        without ``tn`` the allocation is the geometry, as in JAX).
        ``fault_plan`` installs a ``repro_torch.faults.FaultPlan``
        erasure/stutter schedule (``make_params(faults=True)`` only)."""
        fault = fault_states(self.p, [fault_plan], self.device)
        pri = None if region_priors is None else [region_priors]
        tn_b = batch_tunables([tn if tn is not None else make_tunables()],
                              self.device)
        return point_of(self.init_batch(tn_b, pri, fault), 0)

    def init_batch(self, tn: TunableParams, region_priors=None,
                   fault=None) -> SimState:
        """Initial states of a batch of points (``tn`` batched); each
        point's active geometry masks the shared allocation,
        ``region_priors`` (B, K) warm-starts each point's dynamic coding
        unit, and ``fault`` is the batch's fault schedule
        (``state.fault_states``; default: nothing fails). See
        ``state.init_states``."""
        dev = self.device
        mem = init_states(self.p, tn, region_priors, dev, fault,
                          n_cores=self.n_cores)
        B = mem.cycle.shape[0]
        return SimState(
            mem=mem,
            core_ptr=torch.zeros((B, self.n_cores), dtype=torch.int32,
                                 device=dev),
            done_cycle=torch.full((B,), -1, dtype=torch.int32, device=dev),
        )

    # --------------------------------------------------------------- arbiter
    def _arbiter(self, st: SimState, trace: Trace, rs_a,
                 stream_end=None) -> SimState:
        """Push each core's pending request into its destination queue;
        cores rank within their destination queue by core index, and the
        first ``rank`` free slots of a queue go to the first ``rank``
        ranked cores (the JAX arbiter's vectorized rule), for every point.

        ``stream_end`` (chunked replay): (B, n_cores) counts of staged
        requests, INT32_MAX for "more behind this chunk"; ``None`` makes
        the trace length every core's end (single-shot). A pointer at or
        past the end reads a clamped cell, which ``in_range`` masks."""
        p = self.p
        m = st.mem
        B = st.core_ptr.shape[0]
        dev = st.core_ptr.device
        tlen = trace.bank.shape[-1]
        pos = st.core_ptr
        in_range = pos < (tlen if stream_end is None else stream_end)
        pc = pos.clamp(max=tlen - 1).long()[..., None]

        def at(x):
            return x.gather(2, pc)[..., 0]

        v = at(trace.valid) & in_range
        b = at(trace.bank).long().clamp(min=0)
        i = at(trace.row).clamp(min=0)
        isw = at(trace.is_write)
        payload = at(trace.data)

        same_bank = b[:, :, None] == b[:, None, :]
        want_r = v & ~isw
        want_w = v & isw
        rank_r = (same_bank & self._older & want_r[:, None, :]).sum(2)
        rank_w = (same_bank & self._older & want_w[:, None, :]).sum(2)
        free_r = (~m.rq_valid).sum(2)
        free_w = (~m.wq_valid).sum(2)
        full = torch.where(isw, rank_w >= free_w.gather(1, b),
                           rank_r >= free_r.gather(1, b))
        push = v & ~full

        dq = p.queue_depth
        sink = B * p.n_data * dq
        cell0 = add_offset(b * dq, point_offsets(B, p.n_data * dq, dev))
        arange_dq = torch.arange(dq, device=dev).expand(B, p.n_data, dq)

        def target(valid, rank, mask):
            """Flat queue cell of each pushing core (the rank-th free slot of
            its bank's queue), the sink for the others."""
            fr = ~valid
            free_rank = fr.cumsum(2) - 1
            slot_of = torch.full((B, p.n_data, dq + 1), dq, dtype=torch.int64,
                                 device=dev)
            slot_of.scatter_(2, torch.where(fr, free_rank, dq), arange_dq)
            slot = slot_of.flatten(1).gather(
                1, b * (dq + 1) + rank.clamp(max=dq - 1))
            return torch.where(mask, cell0 + slot, sink)

        fr_ = target(m.rq_valid, rank_r, push & ~isw)
        fw_ = target(m.wq_valid, rank_w, push & isw)
        cyc = m.cycle[:, None].expand(B, self.n_cores)
        true = torch.ones((), dtype=torch.bool, device=dev)
        n_regions = m.access_count.shape[1]
        access = torch.cat([m.access_count.flatten(),
                            m.access_count.new_zeros(1)])
        access.index_put_(
            (torch.where(push, add_offset(i.long() // col(rs_a),
                                    point_offsets(B, n_regions, dev)),
                         B * n_regions),),
            torch.ones((), dtype=torch.int32, device=dev), accumulate=True)
        tele = m.tele
        if p.telemetry:
            # the full-queue rejection is the only core-stall source, so
            # this plane sums to stall_cycles; the core ids land in the
            # slots the request scatter below picks
            nd = p.n_data
            stall_cell = add_offset(b * 2 + isw.long(),
                                    point_offsets(B, nd * 2, dev))
            stall_cause, = _add_ones([tele.stall_cause], [torch.where(
                v & full, stall_cell, B * nd * 2)])
            cores = self._cores.int().expand(B, -1)
            tele = tele._replace(stall_cause=stall_cause,
                                 rq_core=_set_flat(tele.rq_core, fr_, cores),
                                 wq_core=_set_flat(tele.wq_core, fw_, cores))
        mem = m._replace(
            rq_row=_set_flat(m.rq_row, fr_, i),
            rq_age=_set_flat(m.rq_age, fr_, cyc),
            rq_valid=_set_flat(m.rq_valid, fr_, true),
            wq_row=_set_flat(m.wq_row, fw_, i),
            wq_age=_set_flat(m.wq_age, fw_, cyc),
            wq_valid=_set_flat(m.wq_valid, fw_, true),
            wq_data=_set_flat(m.wq_data, fw_, payload),
            access_count=access[:-1].view_as(m.access_count),
            stall_cycles=m.stall_cycles + (v & full).sum(1),
            tele=tele,
        )
        ptr = pos + (in_range & (push | ~v)).int()
        return st._replace(mem=mem, core_ptr=ptr)

    # ----------------------------------------------------------- read values
    def _read_values(self, m: MemState, plan: ctl.ReadPlan, cb, ci,
                     rs_a) -> torch.Tensor:
        """The served reads' values, (B, N): the plan through the coded
        row gather on the banks' 4-byte rows (on the card the CUDA
        ``xor_gather`` kernel, fed the plan: one launch for the batch and
        no other op but the output's allocation)."""
        return gather_ops.gather_plan(self.t, plan, cb, ci, m.region_slot,
                                      self.p.region_size, m.fresh_loc, rs_a,
                                      m.banks_data, m.parity_data)

    # ------------------------------------------------------- write datapath
    def _commit_writes(self, m: MemState, plan: ctl.WritePlan, cb, ci_, ca,
                       cv, cd, rs_a):
        """Commit served write payloads in age order (last write wins): the
        age position of each candidate is scatter-maxed into its target
        cell and only the latest served write per cell lands."""
        p, t = self.p, self.t
        rs = p.region_size
        B, n = cb.shape
        dev = cb.device
        b = cb.long().clamp(min=0)
        i = ci_.long().clamp(min=0)
        order = torch.argsort(torch.where(cv, ca, INT32_MAX), dim=1,
                              stable=True)
        pos = torch.empty((B, n), dtype=torch.int32, device=dev)
        pos.scatter_(1, order, torch.arange(n, dtype=torch.int32,
                                            device=dev).expand(B, n))
        rs_a = col(rs_a)
        slot = m.region_slot.gather(1, i // rs_a).long()
        pr = slot.clamp(min=0) * rs + i % rs_a
        kk = (plan.mode.long() - ctl.WMODE_PARK0).clamp(0, MAX_OPTS - 1)
        j = t.opt_parity[b, kk].clamp(min=0)
        is_dir = plan.served & (plan.mode == ctl.WMODE_DIRECT)
        is_park = plan.served & (plan.mode >= ctl.WMODE_PARK0)

        def commit(x, mask, flat):
            sink = x.numel()
            best = torch.full((sink + 1,), -1, dtype=torch.int32, device=dev)
            best.scatter_reduce_(0, torch.where(mask, flat, sink).flatten(),
                                 pos.flatten(), reduce="amax")
            win = mask & (best[flat] == pos)
            return _set_flat(x, torch.where(win, flat, sink), cd)

        cell = add_offset(b * p.n_rows + i,
                          point_offsets(B, p.n_data * p.n_rows, dev))
        banks_data = commit(m.banks_data, is_dir, cell)
        n_pd = m.parity_data[0].numel()
        parity_data = commit(m.parity_data, is_park,
                             add_offset(j * m.parity_data.shape[2] + pr,
                                  point_offsets(B, n_pd, dev)))
        golden = commit(m.golden, plan.served, cell)
        return banks_data, parity_data, golden

    # ------------------------------------------------------------ branches
    def _do_reads(self, m: MemState, rs_a, active=None, port_busy0=None,
                  down=None):
        """The read branch for every point; ``active`` (B,) masks the
        candidates of points that take the other branch. With faults on,
        ``port_busy0`` (B, n_ports + 1) holds the ports busy before the
        walk (default: all idle) and ``down`` (B, n_data) counts the reads
        served degraded because their bank is down."""
        p, t = self.p, self.t
        B = m.cycle.shape[0]
        cb = self._bank_ids.expand(B, -1)
        ci_ = m.rq_row.flatten(1)
        ca = m.rq_age.flatten(1)
        cv = m.rq_valid.flatten(1)
        if active is not None:
            cv = cv & active[:, None]
        plan = ctl.build_read_patterns(
            p, t, cb, ci_, ca, cv,
            self._idle_ports(B) if port_busy0 is None else port_busy0,
            m.fresh_loc,
            m.parity_valid, m.region_slot, rs_a)
        vals = self._read_values(m, plan, cb, ci_, rs_a)
        age = m.cycle[:, None] - ca
        lat = torch.where(plan.served, age, 0).sum(1)
        fault = m.fault
        if down is not None:
            # a from_sym or parity-decoded serve of a down bank's read
            down_deg = down[:, self._bank_ids] & (
                (plan.mode == ctl.MODE_FROM_SYM)
                | ((plan.mode >= ctl.MODE_OPT0)
                   & (plan.mode < ctl.MODE_REDIRECT)))
            deg_f = plan.served & down_deg
            fault = fault._replace(fault_degraded=fault.fault_degraded
                                   + deg_f.sum(1, dtype=torch.int32))
        tele = m.tele
        if p.telemetry:
            # provenance class from the plan's mode (class 4: degraded
            # because the bank is down; a redirect stays class 3), the
            # latency histogram over served candidates, and a read-conflict
            # wait on the bank of each valid candidate left unserved
            cls = self._read_class[plan.mode.long() + 1]
            if down is not None:
                cls = torch.where(down_deg, 4, cls)
            tele = tele._replace(**self._branch_planes(
                tele, "read", plan.served, cv, cb, age, tele.rq_core, cls))
        m = m._replace(
            rq_valid=m.rq_valid & ~plan.served.view_as(m.rq_valid),
            served_reads=m.served_reads + plan.n_served,
            degraded_reads=m.degraded_reads + plan.n_degraded,
            read_latency_sum=m.read_latency_sum + lat,
            fault=fault,
            tele=tele,
        )
        return m, plan.port_busy, CycleOut(plan.served, cb, ci_, vals,
                                           plan.n_served)

    def _do_writes(self, m: MemState, rs_a, active=None, port_busy0=None,
                   down=None):
        """The write branch for every point; ``active`` and ``port_busy0``
        as in ``_do_reads``, ``down`` each point's down banks
        (degraded-write mode) with faults on."""
        p, t = self.p, self.t
        B = m.cycle.shape[0]
        cb = self._bank_ids.expand(B, -1)
        ci_ = m.wq_row.flatten(1)
        ca = m.wq_age.flatten(1)
        cv = m.wq_valid.flatten(1)
        if active is not None:
            cv = cv & active[:, None]
        plan = ctl.build_write_patterns(
            p, t, cb, ci_, ca, cv,
            self._idle_ports(B) if port_busy0 is None else port_busy0,
            m.fresh_loc,
            m.parity_valid, m.region_slot, m.parked_count, m.rc_bank,
            m.rc_row, m.rc_valid, rs_a, down=down)
        banks_data, parity_data, golden = self._commit_writes(
            m, plan, cb, ci_, ca, cv, m.wq_data.flatten(1), rs_a)
        age = m.cycle[:, None] - ca
        lat = torch.where(plan.served, age, 0).sum(1)
        tele = m.tele
        if p.telemetry:
            cls = (plan.mode >= ctl.WMODE_PARK0).long()
            tele = tele._replace(**self._branch_planes(
                tele, "write", plan.served, cv, cb, age, tele.wq_core, cls))
        m = m._replace(
            wq_valid=m.wq_valid & ~plan.served.view_as(m.wq_valid),
            fresh_loc=plan.fresh_loc,
            parity_valid=plan.parity_valid,
            parked_count=plan.parked_count,
            rc_bank=plan.rc_bank, rc_row=plan.rc_row, rc_valid=plan.rc_valid,
            served_writes=m.served_writes + plan.n_served,
            parked_writes=m.parked_writes + plan.n_parked,
            rc_dropped=m.rc_dropped + plan.n_rc_dropped,
            write_latency_sum=m.write_latency_sum + lat,
            banks_data=banks_data, parity_data=parity_data, golden=golden,
            tele=tele,
        )
        zeros = torch.zeros(cb.shape, dtype=torch.int32, device=cb.device)
        out = CycleOut(zeros.bool(), cb, ci_, zeros, plan.n_served)
        return m, plan.port_busy, out

    def _branch_planes(self, tele, side: str, served, cv, cb, age,
                       slot_core, cls) -> dict:
        """One branch's planes: ``{side}_mode_core`` by each served
        candidate's core (``slot_core``, its queue slots' core ids) and
        class ``cls``, ``lat_hist_{side}`` over the served candidates'
        ages, and a wait of cause ``side`` on the bank of each valid
        candidate left unserved. Candidates masked out of this branch are
        not valid, so they count nothing."""
        B = served.shape[0]
        dev = served.device
        nc, nd, hb = self.n_cores, self.p.n_data, obs.HIST_BINS
        nw = len(obs.WAIT_CAUSES)
        mode_plane = getattr(tele, f"{side}_mode_core")
        n_cls = mode_plane.shape[-1]
        core = add_offset(slot_core.flatten(1).long(),
                          point_offsets(B, nc, dev))
        wait = obs.WAIT_READ if side == "read" else obs.WAIT_WRITE
        planes = _add_ones(
            [mode_plane, getattr(tele, f"lat_hist_{side}"), tele.wait_cause],
            [torch.where(served, core * n_cls + cls, B * nc * n_cls),
             torch.where(served, add_offset(obs.lat_bin(age),
                                            point_offsets(B, hb, dev)),
                         B * hb),
             torch.where(cv & ~served,
                         add_offset(cb.long() * nw + wait,
                                    point_offsets(B, nd * nw, dev)),
                         B * nd * nw)])
        return dict(zip((f"{side}_mode_core", f"lat_hist_{side}",
                         "wait_cause"), planes))

    # ------------------------------------------------------------- one cycle
    def cycle_fn(self, st: SimState, trace: Trace,
                 tn: Optional[TunableParams] = None,
                 stream_end=None):
        """One point's cycle (``cycle_batch`` on a batch of one)."""
        se = None if stream_end is None else torch.as_tensor(
            stream_end, dtype=torch.int32, device=self.device)[None]
        nxt, out = self.cycle_batch(batch_of_one(st), batch_of_one(trace),
                                    self.batch_tunables(tn), se)
        return point_of(nxt, 0), point_of(out, 0)

    def cycle_batch(self, st: SimState, trace: Trace, tn: TunableParams,
                    stream_end=None):
        """One cycle of B points lock-step: batched state and trace, batched
        ``tn``, ``stream_end`` (B, n_cores) or None."""
        p, t = self.p, self.t
        rs_a, nr_a = active_geometry(p, tn)
        was_done = st.done_cycle >= 0
        st = self._arbiter(st, trace, rs_a, stream_end)
        m = st.mem
        if p.telemetry:
            # post-arbiter occupancy is the cycle's peak (slots only free
            # up in the branches below)
            tele = m.tele
            m = m._replace(tele=tele._replace(
                rq_hwm=torch.maximum(tele.rq_hwm, m.rq_valid.sum(
                    2, dtype=torch.int32)),
                wq_hwm=torch.maximum(tele.wq_hwm, m.wq_valid.sum(
                    2, dtype=torch.int32))))
        fk = {}                        # the branches' fault arguments

        # fault injection: this cycle's fault masks, dead cycles, the
        # fail-fast drops (after the arbiter counted the request, before
        # the hysteresis reads occupancy) and the builders' busy ports: a
        # down bank's port busy, a stuttering port busy this cycle
        if p.faults:
            fs = m.fault
            down = fplan.bank_down(fs, m.cycle)
            rebuilding = fplan.bank_rebuilding(fs, m.cycle)
            down_hard = down & ~rebuilding
            stut = fplan.stutter_busy(fs, m.cycle)
            # counted until the workload drains, so that a dead bank does
            # not keep a drained point from its quiescent fixed point
            dead_inc = (down & ~was_done[:, None]).long()
            rq_v, wq_v, n_uns, n_lost = finject.drop_unservable(
                p, t, down_hard, m.rq_row, m.rq_valid, m.wq_row, m.wq_valid,
                m.fresh_loc, m.parity_valid, m.region_slot, rs_a)
            fs = fs._replace(
                dead_cycles=fs.dead_cycles + dead_inc,
                unserved_reads=fs.unserved_reads + n_uns,
                lost_writes=fs.lost_writes + n_lost)
            m = m._replace(rq_valid=rq_v, wq_valid=wq_v, fault=fs)
            if p.telemetry:
                m = m._replace(tele=m.tele._replace(
                    dead_cycles=m.tele.dead_cycles + dead_inc))
            fk = dict(down=down, port_busy0=torch.cat(
                [down | stut[:, :p.n_data], stut[:, p.n_data:],
                 torch.zeros_like(stut[:, :1])], 1))   # + the idle sink

        # write-drain hysteresis; one host read picks the branches
        wq_occ = m.wq_valid.sum(2).amax(1)
        any_r = m.rq_valid.flatten(1).any(1)
        any_w = m.wq_valid.flatten(1).any(1)
        wm = torch.where(m.write_mode, wq_occ > tn.wq_lo, wq_occ >= tn.wq_hi)
        serve_writes = (wm | (~any_r & any_w)) & any_w
        # analysis: host-sync one read a cycle picks the builders that run
        sw = serve_writes.tolist()
        if all(sw):
            m, port_busy, out = self._do_writes(m, rs_a, **fk)
        elif not any(sw):
            m, port_busy, out = self._do_reads(m, rs_a, **fk)
        else:
            # the points disagree: both builders on masked candidates, and
            # each point takes its own branch's result, as JAX's ``pick``
            m_r, pb_r, out_r = self._do_reads(m, rs_a, ~serve_writes, **fk)
            m_w, pb_w, out_w = self._do_writes(m, rs_a, serve_writes, **fk)
            m, out, port_busy = _pick(serve_writes, (m_w, out_w, pb_w),
                                      (m_r, out_r, pb_r))
        m = m._replace(write_mode=wm)

        # recoding unit uses leftover ports; a rebuilding bank's port is
        # granted back to it here (and only here), stutter aside
        rc_pb = port_busy
        if p.faults:
            rc_pb = torch.cat([torch.where(rebuilding, stut[:, :p.n_data],
                                           port_busy[:, :p.n_data]),
                               port_busy[:, p.n_data:]], 1)
        rc = recode_steps(
            p, t, rc_pb, m.fresh_loc, m.parity_valid, m.parked_count,
            m.rc_bank, m.rc_row, m.rc_valid, m.region_slot, m.banks_data,
            m.parity_data, rs_a, down=down_hard if p.faults else None)
        m = m._replace(
            fresh_loc=rc.fresh_loc, parity_valid=rc.parity_valid,
            parked_count=rc.parked_count, rc_valid=rc.rc_valid,
            banks_data=rc.banks_data, parity_data=rc.parity_data)
        if p.telemetry:
            # ring entries still pending after the recode unit charge a
            # recode-pending wait to their bank
            tele = m.tele
            nw = len(obs.WAIT_CAUSES)
            B = m.cycle.shape[0]
            cell = add_offset(m.rc_bank.long().clamp(min=0) * nw
                              + obs.WAIT_RECODE,
                              point_offsets(B, p.n_data * nw, m.cycle.device))
            wait_cause, = _add_ones([tele.wait_cause], [torch.where(
                m.rc_valid, cell, B * p.n_data * nw)])
            m = m._replace(tele=tele._replace(
                recode_retired=tele.recode_retired + rc.n_recoded,
                wait_cause=wait_cause))
        # online rebuild: sweep cells into the recode ring while a bank
        # rebuilds; latch ``rebuilt`` (the bank rejoins) on completion
        if p.faults:
            rb_bank, rb_row, rb_valid, fs2 = finject.rebuild_scan(
                p, t, m.fault, m.cycle, rebuilding, down_hard, m.fresh_loc,
                m.parity_valid, m.region_slot, m.rc_bank, m.rc_row,
                m.rc_valid, rs_a, nr_a)
            m = m._replace(rc_bank=rb_bank, rc_row=rb_row,
                           rc_valid=rb_valid, fault=fs2)
        # dynamic coding unit; it starts nothing new once the workload drained
        dy = dynamic_step(
            p, t, tn, m.cycle, m.region_slot, m.slot_region, m.access_count,
            m.parked_count, m.parity_valid, m.parity_data, m.banks_data,
            m.enc_region, m.enc_remaining, m.enc_slot, m.switches,
            quiesce=was_done)
        m = m._replace(
            region_slot=dy.region_slot, slot_region=dy.slot_region,
            access_count=dy.access_count, parity_valid=dy.parity_valid,
            parity_data=dy.parity_data, enc_region=dy.enc_region,
            enc_remaining=dy.enc_remaining, enc_slot=dy.enc_slot,
            switches=dy.switches)
        # a core is consumed once its pointer reaches its stream end (never,
        # for a chunk with more behind it: INT32_MAX)
        tlen = trace.bank.shape[-1]
        consumed = (st.core_ptr
                    >= (tlen if stream_end is None else stream_end)).all(1)
        drained = ~m.rq_valid.flatten(1).any(1) & ~m.wq_valid.flatten(
            1).any(1)
        done_cycle = torch.where((st.done_cycle < 0) & consumed & drained,
                                 m.cycle, st.done_cycle)
        m = m._replace(cycle=m.cycle + 1)
        return SimState(m, st.core_ptr, done_cycle), out

    # ------------------------------------------------------------------- run
    def check_trace(self, trace: Trace) -> None:
        """Raise unless every bank and row of ``trace`` (one point's or a
        batch's) is below the geometry's bounds (negative values read as 0,
        as in JAX). JAX clamps or drops an index past the end where torch
        would raise, or assert on the card, so a run checks its trace once,
        up front."""
        if trace.bank.numel() == 0:
            return
        bank, row = torch.stack([trace.bank.max(), trace.row.max()]).tolist()
        if bank >= self.p.n_data or row >= self.p.n_rows:
            raise ValueError(
                f"trace reaches bank {bank} / row {row}; the system has "
                f"{self.p.n_data} banks of {self.p.n_rows} rows")

    def _run(self, st: SimState, trace: Trace, n_cycles: int,
             tn: Optional[TunableParams] = None,
             on_cycle: Optional[Callable] = None):
        """``n_cycles`` cycles of one point from ``st`` (a batch of one):
        the final state and the (n_cycles,) int32 accesses served per
        cycle. ``on_cycle(before, after, out)`` is called with one point's
        states after every cycle when given."""
        self.check_trace(trace)
        tn_b = self.batch_tunables(tn)
        st_b, tr_b = batch_of_one(st), batch_of_one(trace)
        served = []
        for _ in range(n_cycles):
            nxt, out = self.cycle_batch(st_b, tr_b, tn_b)
            if on_cycle is not None:
                on_cycle(*point_of((st_b, nxt, out), 0))
            st_b = nxt
            served.append(out.n_served)
        n_served = (torch.cat(served) if served else
                    torch.zeros((0,), dtype=torch.int32, device=self.device))
        return point_of(st_b, 0), n_served

    def run(self, trace: Trace, n_cycles: int,
            tn: Optional[TunableParams] = None,
            st: Optional[SimState] = None, fault_plan=None,
            on_cycle: Optional[Callable] = None) -> SimResult:
        """Single-shot replay of all ``n_cycles`` cycles; ``st`` carries in
        an explicit initial state. ``fault_plan`` installs an
        erasure/stutter schedule on the fresh initial state (ignored when
        ``st`` is given: put the plan in that state)."""
        tn = tn if tn is not None else self.tunables
        st, _ = self._run(
            st if st is not None else self.init(tn, fault_plan=fault_plan),
            trace, n_cycles, tn, on_cycle)
        return self.summarize(st)

    def run_chunk(self, st: SimState, trace: Trace, stream_end,
                  n_cycles: int,
                  tn: Optional[TunableParams] = None,
                  on_cycle: Optional[Callable] = None) -> SimState:
        """One streaming-replay step of one point (``run_chunk_batch`` on a
        batch of one): advance ``st`` over a staged chunk. ``stream_end[c]``
        is core ``c``'s count of staged requests when its stream ends
        inside the chunk, else INT32_MAX. ``on_cycle(before, after, out)``
        sees one point's states after every cycle when given."""
        hook = None if on_cycle is None else (
            lambda *a: on_cycle(*point_of(a, 0)))
        se = torch.as_tensor(stream_end, dtype=torch.int32,
                             device=self.device)[None]
        st = self.run_chunk_batch(batch_of_one(st), batch_of_one(trace), se,
                                  n_cycles, self.batch_tunables(tn), hook)
        return point_of(st, 0)

    def run_chunk_batch(self, st: SimState, trace: Trace, stream_end,
                        n_cycles: int, tn: TunableParams,
                        on_cycle: Optional[Callable] = None) -> SimState:
        """Advance B points lock-step over a staged chunk, or over whole
        traces when ``stream_end`` is None.

        ``trace`` holds each point's cores' next (up to) ``tlen`` requests;
        ``stream_end`` (B, n_cores) as in ``run_chunk``. Cycles run until,
        checked before each one as JAX's ``lax.while_loop`` does: (a) some
        core of some point with more data behind the chunk has consumed its
        staged requests (starved: the caller restages), (b) every point is
        ``quiescent``, or (c) ``n_cycles`` cycles ran (this call's budget,
        apart from the states' own ``cycle``). A point that quiesced before
        the others runs observable no-op cycles. The exit test is one host
        read a cycle. ``on_cycle(before, after, out)`` sees the batched
        states after every cycle when given. ``run_chunk_shards`` on one
        shard."""
        hook = None if on_cycle is None else (
            lambda before, after, out: on_cycle(before[0], after[0], out[0]))
        return run_chunk_shards(
            [self], [st], [trace],
            None if stream_end is None else [stream_end], n_cycles, [tn],
            hook)[0]

    def summarize(self, st: SimState) -> SimResult:
        return summarize_batch(batch_of_one(st))[0]


def run_chunk_shards(systems: List[CodedMemorySystem], sts: List[SimState],
                     traces: List[Trace], stream_ends, n_cycles: int,
                     tns: List[TunableParams],
                     on_cycle: Optional[Callable] = None) -> List[SimState]:
    """``run_chunk_batch`` of one batch split on its point axis into
    shards, shard ``k`` on ``systems[k]``'s device (the sweep engine's
    sharding, ``repro_torch.sweep.engine``): one host loop steps every
    shard each cycle and takes the exit test over all of them, one host
    read a cycle, so (a) any starved core of any shard or (b) every point
    of every shard quiescent ends the call, as the unsharded batch's
    ``while_loop`` would. ``stream_ends`` is None or one (B_k, n_cores)
    per shard. ``on_cycle(befores, afters, outs)`` sees the shards' lists
    after every cycle when given. Returns the shards' states."""
    for sys_, trace in zip(systems, traces):
        sys_.check_trace(trace)
    tlen = traces[0].bank.shape[-1]
    ses: List = [None] * len(sts)
    if stream_ends is not None:
        ses = [torch.as_tensor(se, dtype=torch.int32, device=sys_.device)
               for se, sys_ in zip(stream_ends, systems)]
        more = [se > tlen for se in ses]
    lead = systems[0].device
    # one shard runs exactly run_chunk_batch's ops (profiles count them)
    for _ in range(n_cycles):
        if stream_ends is None:
            quiet = [quiescent(st).all() for st in sts]
            # analysis: host-sync the exit test, one read a cycle
            stop = (bool(quiet[0]) if len(sts) == 1 else all(
                torch.stack([q.to(lead) for q in quiet]).tolist()))
        else:
            flags = []
            for st, m in zip(sts, more):
                q = quiescent(st).all()
                flags.append(torch.stack([((st.core_ptr >= tlen) & m).any(),
                                          q]))
            if len(flags) == 1:
                # analysis: host-sync the exit test, one read a cycle
                stop = any(flags[0].tolist())
            else:
                # analysis: host-sync the exit test, one read a cycle
                rows = torch.stack([f.to(lead) for f in flags]).tolist()
                stop = any(r[0] for r in rows) or all(r[1] for r in rows)
        if stop:
            break
        steps = [sys_.cycle_batch(st, trace, tn, se) for sys_, st, trace, tn,
                 se in zip(systems, sts, traces, tns, ses)]
        nxts = [nxt for nxt, _ in steps]
        if on_cycle is not None:
            on_cycle(sts, nxts, [out for _, out in steps])
        sts = nxts
    return sts
