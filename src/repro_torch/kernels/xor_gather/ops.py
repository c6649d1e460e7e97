"""Public wrappers of the coded row gather and the controller-plan → kernel
columns bridge (``repro`` counterpart: ``kernels/xor_gather/ops.py``).

Dispatch is by the tensors' device, with no switch and no fallback: CUDA
tensors go through the hand-written kernel (which launches or raises), CPU
tensors through the plain PyTorch version. ``calls`` counts the calls of
``gather_decode`` and ``gather_plan`` on any device; on the card it must
equal the kernel's ``launches`` (less the empty plans, which launch
nothing).

Two entries: ``gather_plan`` serves a read plan straight from the
controller's tensors (the kernel does ``plan_columns``' arithmetic per
request: one launch and no other op on the card), and ``gather_decode``
takes JAX's seven columns. The plain version of ``gather_plan`` is
``gather_decode_plain`` of ``plan_columns``.

The point axis: ``plan_columns`` of B points' plans gives one set of
(B·N,) columns whose bank, parity and sibling ids are clamped inside their
point and offset by its index, and ``gather_decode`` views banks (B,
n_data, L, W) and parities (B, n_par, Lp, W) as (B·n_data, L, W) and
(B·n_par, Lp, W): one launch serves every point's reads. ``gather_plan``
takes the batched tensors as they are.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.codes import MAX_OPTS
from repro_torch.core.controller import (MODE_OPT0, MODE_REDIRECT, ReadPlan,
                                        col)
from repro_torch.core.state import batch_of_one
from repro_torch.kernels.common import as_lanes
from repro_torch.kernels.xor_gather.kernel import (gather_decode_cuda,
                                                   gather_plan_cuda)
# The module, not its name: ``ref`` imports ``core.codes``, whose package
# imports the system and so this module.
from repro_torch.kernels.xor_gather import ref

calls = 0


class PlanColumns(NamedTuple):
    bank: torch.Tensor
    row: torch.Tensor
    mode: torch.Tensor
    par: torch.Tensor
    prow: torch.Tensor
    sib0: torch.Tensor
    sib1: torch.Tensor


def plan_columns(
    tables,
    plan: ReadPlan,
    cand_bank: torch.Tensor,
    cand_row: torch.Tensor,
    region_slot: torch.Tensor,
    region_size: int,
    fresh_loc: torch.Tensor,
    rs_active=None,
) -> PlanColumns:
    """Expand a controller ReadPlan into the kernel's per-request int32
    columns. ``tables`` is the port's ``JTables`` on the plan's device.
    Parity rows use the allocated stride ``region_size`` and the offset
    ``row % rs_active`` (``rs_active``: an int, default ``region_size``, or
    each point's (B,) tensor). One point's plan ((N,) candidates) gives
    (N,) columns; B points' plans ((B, N) candidates, (B, ...) state) give
    (B·N,) columns with each point's bank, parity and sibling ids offset
    for the banks and parities viewed (B·n_data, ...), (B·n_par, ...)."""
    return _plan_columns(tables.opt_parity, tables.opt_sibs,
                         tables.par_members.shape[0], cand_bank, cand_row,
                         plan.mode, plan.served, region_slot, region_size,
                         fresh_loc, rs_active)


def _plan_columns(opt_parity, opt_sibs, n_par, cand_bank, cand_row, mode,
                  served, region_slot, region_size, fresh_loc,
                  rs_active) -> PlanColumns:
    """``plan_columns`` on the plan's tensors. Every index is clamped as
    JAX's gathers clamp it, and the ids that pick a bank or a parity inside
    their point before the point offset (so an id past its point's end
    never reads the next point's rows)."""
    if cand_bank.dim() == 1:
        mode, served, cand_bank, cand_row, region_slot, fresh_loc = \
            batch_of_one((mode, served, cand_bank, cand_row, region_slot,
                          fresh_loc))
    B, nd, rows = fresh_loc.shape
    rs_a = col(region_size if rs_active is None else rs_active)
    b = cand_bank.long().clamp(0, nd - 1)
    i = cand_row.long().clamp(min=0)
    k = (mode.long() - MODE_OPT0).clamp(0, MAX_OPTS - 1)
    is_opt = (mode >= MODE_OPT0) & (mode < MODE_REDIRECT)
    is_rd = mode == MODE_REDIRECT
    j_opt = opt_parity[b, k]
    j_rd = fresh_loc.flatten(1).gather(
        1, b * rows + i.clamp(max=rows - 1)).long() - 1
    par = torch.where(is_opt, j_opt, torch.where(is_rd, j_rd, 0)).clamp(
        0, n_par - 1)
    region = (i // rs_a).clamp(max=region_slot.shape[1] - 1)
    slot = region_slot.gather(1, region).long()
    prow = slot.clamp(min=0) * region_size + i % rs_a
    sibs = torch.where(is_opt[..., None], opt_sibs[b, k].clamp(max=nd - 1),
                       -1)
    mode = torch.where(served, mode, -1)
    if B > 1:
        pt = torch.arange(B, device=b.device)[:, None]
        b = b + pt * nd
        par = par + pt * n_par
        sibs = torch.where(sibs >= 0, sibs + pt[..., None] * nd, -1)
    # one int32 block, each column a contiguous row of it
    cols = torch.stack([b, i, mode.long(), par, prow, sibs[..., 0],
                        sibs[..., 1]]).int()
    return PlanColumns(*cols.flatten(1).unbind(0))


def gather_plan_columns(banks, parities, cand_bank, cand_row, mode, served,
                        region_slot, fresh_loc, rs_active, region_size,
                        opt_parity, opt_sibs) -> PlanColumns:
    """The (B·N,) columns of ``gather_plan_cuda``'s operands: what the
    kernel computes per request, for the banks and parities viewed
    (B·n_data, L, ...) and (B·n_par, Lp, ...)."""
    return _plan_columns(opt_parity, opt_sibs,
                         parities.shape[cand_bank.dim() - 1], cand_bank,
                         cand_row, mode, served, region_slot, region_size,
                         fresh_loc, rs_active)


def gather_plan_plain(*args) -> torch.Tensor:
    """The plain version of ``kernel.gather_plan_cuda`` (same operands):
    ``ref.gather_decode_plain`` of ``gather_plan_columns``, (B, N, *lanes)
    for (B, N) candidates ((N, *lanes) for one point)."""
    banks, parities, cand_bank = args[:3]
    lead = cand_bank.dim() - 1
    lane_shape = tuple(banks.shape[lead + 2:])
    cols = gather_plan_columns(*args)
    if lead:
        banks, parities = banks.flatten(0, 1), parities.flatten(0, 1)
    out = ref.gather_decode_plain(banks.reshape(*banks.shape[:2], -1),
                                  parities.reshape(*parities.shape[:2], -1),
                                  *cols)
    return out.view(tuple(cand_bank.shape) + lane_shape)


def gather_plan(tables, plan: ReadPlan, cand_bank: torch.Tensor,
                cand_row: torch.Tensor, region_slot: torch.Tensor,
                region_size: int, fresh_loc: torch.Tensor, rs_active,
                banks: torch.Tensor, parities: torch.Tensor) -> torch.Tensor:
    """Serve B points' read plans: the (B, N, *lanes) values of the plans'
    reads (unserved ones 0) from int8/int16/int32 lanes, banks (B, n_data,
    L, *lanes) and parities (B, n_par, Lp, *lanes); one point's plan ((N,)
    candidates) reads (n_data, L, *lanes) banks. The other arguments are
    ``plan_columns``': equal to ``gather_decode(banks, parities,
    plan_columns(...))`` shaped (B, N, *lanes); on the card one launch,
    with the columns computed in the kernel."""
    global calls
    calls += 1
    args = (banks, parities, cand_bank, cand_row, plan.mode, plan.served,
            region_slot, fresh_loc,
            region_size if rs_active is None else rs_active, region_size,
            tables.opt_parity, tables.opt_sibs)
    dev = banks.device.type
    if dev == "cuda":
        return gather_plan_cuda(*args)
    if dev == "cpu":
        return gather_plan_plain(*args)
    raise ValueError(f"gather_plan: no datapath for device {dev}")


def gather_decode(banks: torch.Tensor, parities: torch.Tensor,
                  cols: PlanColumns,
                  value_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Serve one cycle's read pattern: (N, W) rows in ``value_dtype``
    (default ``banks.dtype``); unserved entries read zero. Any N, including
    an empty plan. Banks (B, n_data, L, W) and parities (B, n_par, Lp, W)
    serve B points' columns from ``plan_columns`` in one launch."""
    global calls
    calls += 1
    if banks.dim() == 4:
        banks, parities = banks.flatten(0, 1), parities.flatten(0, 1)
    if value_dtype is None:
        value_dtype = banks.dtype
    if banks.dtype.is_floating_point:
        banks = as_lanes(banks)
    if parities.dtype.is_floating_point:
        parities = as_lanes(parities)
    if parities.dtype != banks.dtype:
        raise TypeError(f"lane dtype mismatch: {banks.dtype} vs "
                        f"{parities.dtype}")
    dev = banks.device.type
    if dev == "cuda":
        out = gather_decode_cuda(banks, parities, *cols)
    elif dev == "cpu":
        out = ref.gather_decode_plain(banks, parities, *cols)
    else:
        raise ValueError(f"gather_decode: no datapath for device {dev}")
    return out if out.dtype == value_dtype else out.view(value_dtype)
