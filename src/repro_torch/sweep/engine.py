"""Batched sweep engine: one lock-step loop per static shape, not per
point; the port of ``repro/sweep/engine.py``.

The looped path (``repro_torch.sim.ramulator.simulate``) runs one point at
a time, each cycle a few hundred to a thousand small launches and a few
host reads. This engine instead:

  1. partitions the sweep by static signature (``repro_torch.sweep.grid``),
  2. runs each partition's points lock-step on the core's point axis
     (``CodedMemorySystem.cycle_batch``): seeds, trace contents and
     ``TunableParams`` all batch, and one batched cycle makes about the
     launches of one point's cycle, so B points cost close to one point's
     wall time,
  3. leaves the loop once every point is quiescent (or the cycle bound
     runs out), one host read a cycle, and
  4. summarizes with a single device-to-host copy per partition.

Per-point results are bit-identical to the looped path and to the JAX
engine (tests/test_torch_sweep.py).

Sharding the point axis (``shard=True``, JAX's default). Where
``repro_torch.launch.mesh.make_sweep_mesh`` gives more than one device
(every visible card), the batch is padded to a multiple of the device
count with copies of its last point (its initial state, which holds its
priors and fault schedule, its trace and its tunables: ``_pad_points``,
``_replicate_tail``), split into contiguous
shards, one per device (``_maybe_shard``), and run by one host loop that
steps every shard each cycle and takes the exit test over all of them
(``core.system.run_chunk_shards``), so cycle counts, ``done_cycle`` and
quiesced points' no-op cycles equal the unsharded run's. A copy quiesces
and starves exactly when its original does. Results, telemetry
snapshots, ``return_state``'s states and what ``on_cycle`` sees are the
unpadded batch gathered onto the first shard's device. On one device
``shard=True`` pads and splits nothing: it is the ``False`` run.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.codes import get_tables
from repro_torch.core.state import (MemParams, TunableParams, _map,
                                    batch_tunables, fault_states,
                                    make_params, make_tunables, point_of)
from repro_torch.core.system import (CodedMemorySystem, SimResult, SimState,
                                     Trace, run_chunk_shards, summarize_batch)
from repro_torch.faults.plan import FaultState, plan_from_spec
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import mesh
from repro_torch.obs.planes import Telemetry, TelemetrySnapshot, snapshot
from repro_torch.sweep import workloads
from repro_torch.sweep.grid import (GridBatch, SweepPoint,
                                    batch_geometry_alloc, partition,
                                    static_signature)

# One system per (static signature, geometry allocation, traced, device),
# so re-running a sweep rebuilds no tables.
_SYSTEMS: Dict[Tuple, CodedMemorySystem] = {}


def params_for(pt: SweepPoint,
               geometry_alloc: Optional[Tuple[int, int, int]] = None,
               traced_geometry: bool = False) -> MemParams:
    """The ``MemParams`` of the system a batch led by ``pt`` runs on, at
    the ``geometry_alloc`` allocation (default: the point's own)."""
    rs_alloc, nr_alloc, ns_alloc = (geometry_alloc if geometry_alloc
                                    is not None else pt.derived_slots())
    return make_params(get_tables(pt.scheme, n_data=pt.n_data),
                       n_rows=pt.n_rows, alpha=pt.alpha, r=pt.r,
                       queue_depth=pt.queue_depth, coalesce=pt.coalesce,
                       recode_cap=pt.recode_cap, max_syms=pt.max_syms,
                       encode_rows_per_cycle=pt.encode_rows_per_cycle,
                       recode_budget=pt.recode_budget,
                       n_slots_alloc=ns_alloc, region_size_alloc=rs_alloc,
                       n_regions_alloc=nr_alloc,
                       traced_geometry=traced_geometry,
                       telemetry=pt.telemetry, faults=bool(pt.faults))


def system_for(pt: SweepPoint,
               geometry_alloc: Optional[Tuple[int, int, int]] = None,
               traced_geometry: bool = False,
               device=None) -> CodedMemorySystem:
    """The system a batch led by ``pt`` runs on. The cache keys on the
    actual (region_size, n_regions, n_slots) allocation, since
    ``static_signature`` drops α and r, and on ``traced_geometry`` (a
    single-geometry batch indexes with the allocation's python ints)."""
    dev = resolve_device(device)
    alloc = (geometry_alloc if geometry_alloc is not None
             else pt.derived_slots())
    key = (static_signature(pt), alloc, traced_geometry, str(dev))
    sys_ = _SYSTEMS.get(key)
    if sys_ is None:
        sys_ = CodedMemorySystem(get_tables(pt.scheme, n_data=pt.n_data),
                                 params_for(pt, alloc, traced_geometry),
                                 n_cores=pt.n_cores, device=dev)
        _SYSTEMS[key] = sys_
    return sys_


def stack_tunables(points: Sequence[SweepPoint], queue_depth: int,
                   device) -> TunableParams:
    """Each point's tunables, its own geometry in the ``*_active`` fields,
    as one batched ``TunableParams`` on ``device``."""
    tns = []
    for pt in points:
        rs, nr, ns = pt.derived_slots()
        tns.append(make_tunables(queue_depth=queue_depth,
                                 select_period=pt.select_period,
                                 wq_hi=pt.wq_hi, wq_lo=pt.wq_lo,
                                 n_slots_active=ns,
                                 region_size_active=rs,
                                 n_regions_active=nr))
    return batch_tunables(tns, device)


def _stack_faults(points: Sequence[SweepPoint], p: MemParams,
                  device) -> Optional[FaultState]:
    """Each point's fault schedule (its ``faults`` spec; the no-fault one
    for an empty spec) as one batched ``FaultState`` on ``device``, None
    on a faults-off system. The schedule is state, so points with
    different plans share a batch."""
    return fault_states(
        p, [plan_from_spec(pt.faults, p.n_data, p.n_ports) for pt in points],
        device)


def _stack_priors(priors: Sequence, n_points: int):
    """Ragged per-point region-prior arrays → one -1-padded (B, K) array
    (None when no point has priors)."""
    arrs = [np.asarray(pr.cpu() if isinstance(pr, torch.Tensor) else
                       (pr if pr is not None else []), np.int32).reshape(-1)
            for pr in priors]
    k = max((a.size for a in arrs), default=0)
    if k == 0:
        return None
    out = np.full((n_points, k), -1, np.int32)
    for b, a in enumerate(arrs):
        out[b, :a.size] = a
    return out


def mixed_geometry(points: Sequence[SweepPoint]) -> bool:
    """Whether a batch mixes (region_size, n_regions) geometries: only then
    is its geometry indexing traced; a uniform batch (trace, seed, tunable
    or α axes at one r) indexes with the allocation's python ints."""
    return len({pt.derived_slots()[:2] for pt in points}) > 1


def shard_devices(device: torch.device, shard: bool) -> List[torch.device]:
    """The devices a batch's point axis is split over: ``mesh.
    make_sweep_mesh``'s when ``shard`` and it gives more than one, else
    ``device`` alone."""
    devs = mesh.make_sweep_mesh(device=device) if shard else []
    return list(devs) if len(devs) > 1 else [device]


def _pad_points(n_points: int, n_devices: int) -> int:
    """Rows of padding that bring ``n_points`` to a multiple of the device
    count (0 when it divides, or on one device)."""
    return (-n_points) % n_devices if n_devices > 1 else 0


def _replicate_tail(tree, pad: int):
    """Batched ``tree`` (None stays None) with ``pad`` copies of its last
    point appended on the point axis."""
    if not pad:
        return tree
    return _map(lambda x: torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]),
                tree)


def _maybe_shard(tree, devices: Sequence[torch.device]) -> list:
    """The (padded) batched ``tree`` as one contiguous shard per device,
    shard ``k`` on ``devices[k]``; on one device, ``[tree]`` itself."""
    if len(devices) == 1:
        return [tree]
    n = len(devices)
    return [_map(lambda x, k=k, d=d: x.chunk(n)[k].to(d), tree)
            for k, d in enumerate(devices)]


def _gather(shards: Sequence, n_points: int, device: torch.device):
    """The shards' trees concatenated on the point axis onto ``device``,
    the padding rows dropped; one shard is returned as it is."""
    if len(shards) == 1:
        return shards[0]
    first = shards[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([x.to(device) for x in shards])[:n_points]
    if isinstance(first, tuple):
        leaves = (_gather([s[i] for s in shards], n_points, device)
                  for i in range(len(first)))
        return (type(first)(*leaves) if hasattr(first, "_fields")
                else tuple(leaves))
    return first


def gathered_hook(on_cycle, n_points: int, device: torch.device):
    """``run_chunk_shards``' hook calling ``on_cycle(before, after, out)``
    with the unpadded batch gathered onto ``device`` (None for None)."""
    if on_cycle is None:
        return None
    return lambda befores, afters, outs: on_cycle(
        *(_gather(x, n_points, device) for x in (befores, afters, outs)))


def run_batch(batch: GridBatch, traces: Optional[Sequence[Trace]] = None,
              shard: bool = True,
              region_priors: Optional[Sequence] = None,
              collect_telemetry: bool = False,
              *, device=None,
              return_state: bool = False,
              on_cycle=None):
    """Evaluate one shape-compatible batch lock-step on ``device`` (the
    card unless the caller names another), its point axis sharded over
    ``make_sweep_mesh``'s devices when ``shard`` (see the module
    docstring): the per-point SimResults; with ``collect_telemetry`` also
    the points' ``TelemetrySnapshot``s (None for a telemetry-off batch;
    one more device-to-host copy of the small planes), and with
    ``return_state`` the final batched ``SimState`` last: ``(results[,
    snapshots][, state])``. ``on_cycle(before, after, out)`` sees the
    batched states after every cycle when given."""
    pts = batch.points
    devices = shard_devices(resolve_device(device), shard)
    systems = [system_for(pts[0], geometry_alloc=batch_geometry_alloc(pts),
                          traced_geometry=mixed_geometry(pts), device=d)
               for d in devices]
    sys_ = systems[0]
    dev = sys_.device
    if traces is None:
        traces = [workloads.build_trace(pt, index=i, device=dev)
                  for i, pt in zip(batch.indices, pts)]
    for pt, tr in zip(pts, traces):
        if tuple(tr.bank.shape) != (pt.n_cores, pt.length):
            raise ValueError(
                f"trace shape {tuple(tr.bank.shape)} does not match point "
                f"geometry ({pt.n_cores}, {pt.length})")
    trace_b = Trace(*(x.to(dev) for x in workloads.stack_traces(traces)))
    tn_b = stack_tunables(pts, sys_.p.queue_depth, dev)
    priors_b = (_stack_priors(region_priors, len(pts))
                if region_priors is not None else None)
    st_b = sys_.init_batch(tn_b, priors_b, _stack_faults(pts, sys_.p, dev))
    shards = _maybe_shard(
        _replicate_tail((st_b, trace_b, tn_b),
                        _pad_points(len(pts), len(devices))), devices)
    sts = run_chunk_shards(systems, [s[0] for s in shards],
                           [s[1] for s in shards], None,
                           pts[0].resolved_cycles(), [s[2] for s in shards],
                           gathered_hook(on_cycle, len(pts), dev))
    st = _gather(sts, len(pts), dev)
    out = (summarize_batch(st),)
    if collect_telemetry:
        out += (telemetry_snapshots(st),)
    if return_state:
        out += (st,)
    return out if len(out) > 1 else out[0]


def telemetry_snapshots(st: SimState) -> List[Optional[TelemetrySnapshot]]:
    """Each point's ``TelemetrySnapshot`` of a batched state (the planes
    copied to the host once), or None for each point of a telemetry-off
    state."""
    tele = st.mem.tele
    B = st.done_cycle.shape[0]
    if tele is None:
        return [None] * B
    host = Telemetry(*(x.cpu() for x in tele))
    return [snapshot(host, point=b) for b in range(B)]


def run_points(points: Sequence[SweepPoint],
               traces: Optional[Sequence[Trace]] = None,
               shard: bool = True,
               region_priors: Optional[Sequence] = None,
               collect_telemetry: bool = False,
               *, device=None, return_state: bool = False,
               on_cycle=None):
    """Evaluate an arbitrary sweep, one batch per ``partition`` group;
    results align with ``points`` order. ``region_priors`` aligns 1:1 with
    ``points``: each entry is None (cold start) or a ranked hot-region
    array warm-starting that point's dynamic coding unit. With
    ``return_state`` also each point's final ``SimState`` (views into its
    batch's state, allocated at the batch's geometry).
    ``on_cycle(batch, before, after, out)`` sees each batch's states after
    every cycle when given. ``collect_telemetry`` returns ``(results,
    snapshots)``: each point's ``TelemetrySnapshot``, None for a
    telemetry-off point (``run_batch``); ``return_state`` appends the
    states."""
    if traces is not None and len(traces) != len(points):
        raise ValueError("traces must align 1:1 with points")
    if region_priors is not None and len(region_priors) != len(points):
        raise ValueError("region_priors must align 1:1 with points")
    results: List[Optional[SimResult]] = [None] * len(points)
    states: List[Optional[SimState]] = [None] * len(points)
    snaps: List[Optional[TelemetrySnapshot]] = [None] * len(points)
    for batch in partition(points):
        btraces = ([traces[i] for i in batch.indices]
                   if traces is not None else None)
        bpriors = ([region_priors[i] for i in batch.indices]
                   if region_priors is not None else None)
        hook = None if on_cycle is None else functools.partial(on_cycle,
                                                               batch)
        res, st = run_batch(batch, btraces, shard, bpriors, device=device,
                            return_state=True, on_cycle=hook)
        bsnaps = (telemetry_snapshots(st) if collect_telemetry
                  else [None] * len(batch))
        for k, i in enumerate(batch.indices):
            results[i] = res[k]
            states[i] = point_of(st, k)
            snaps[i] = bsnaps[k]
    out = (results,)
    if collect_telemetry:
        out += (snaps,)
    if return_state:
        out += (states,)
    return out if len(out) > 1 else results


def run_sweep(points: Sequence[SweepPoint],
              traces: Optional[Sequence[Trace]] = None,
              shard: bool = True,
              region_priors: Optional[Sequence] = None,
              *, device=None, on_cycle=None):
    """Evaluate a sweep (``run_points``, on the card unless ``device`` names
    another) and wrap it in a ``SweepResultSet`` (results store)."""
    from repro_torch.sweep.results import SweepRecord, SweepResultSet
    res = run_points(points, traces, shard, region_priors, device=device,
                     on_cycle=on_cycle)
    return SweepResultSet([SweepRecord(pt, r) for pt, r in zip(points, res)])


def clear_caches():
    """Drop memoized systems — mainly for tests."""
    _SYSTEMS.clear()
