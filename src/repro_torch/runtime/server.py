"""Serving runtime: continuous batching over the coded KV page pool
(``repro.runtime.server`` counterpart, pooled path).

Request lifecycle: queued -> prefill (one call per admitted request, the
prompt left-padded with token 0 to ``max_prompt``) -> decode slot (joins the
batched decode step) -> finished (EOS / ``max_new_tokens``). Slots are
fixed (``n_slots``); free slots decode garbage that is ignored.

Models: the dense and MoE decoders, the vision-prefix decoder, whose
prompts get zero patch embeddings over their first ``n_patches``
positions at admission (as the JAX ``Server`` gives them), the SSM
decoder and the RG-LRU + local-attention hybrid, whose ring cache also
holds each slot's O(1) recurrent state (conv tails and f32 states), and
the audio encoder-decoder, whose prompts get zero frame embeddings (1,
max(enc_frames, 8), d_model) at admission, as the JAX ``Server`` gives
them; its ring cache holds each slot's cross-attention K/V over those
frames (``xk``/``xv``, sized to the frame count: JAX's ``Server`` sizes
them to no frames and fails at its first install).

Storage: when the config declares KV banks (``cfg.kv_banks > 0``), uses
global attention and has no frontend, decode runs over the coded KV page
pool. Admission assigns physical pages from a FIFO free list (freed pages
recycle at the tail, so a long-running server churns placement), appends
mark the code-status table, reads follow the planner's degraded-read plan
through the pool gather, and the ReCoding unit refreshes parity between
steps.
``ServeConfig.coded=False`` serves from the uncoded pool (no parity), and
``ServeConfig.telemetry=True`` keeps the device metric planes in the decode
cache (``serve_snapshot()`` reads them). Otherwise (``kv_banks == 0`` or a
sliding window, a vision prefix, the ssm, hybrid or audio family)
decode runs over a ring cache (``lm.cache_spec``); admission copies
every leaf of the one-request prefill cache into the slot, in place.

Fault tolerance: ``snapshot()`` copies the server state (cache, slot table,
page accounting) to host numpy arrays and ``restore_snapshot()`` builds
fresh tensors from them on the server's own device, so a serving node can
be replaced mid-stream, also by one on another device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import lm
from repro_torch.obs import serve as obs_serve
from repro_torch.runtime import kvbank as kb
from repro_torch.runtime import steps as steps_mod


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int = 4
    max_prompt: int = 64
    max_seq: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1            # -1: never stop early
    # ---- coded KV page pool ----
    coded: bool = True          # False: uncoded pool (no parity arrays)
    telemetry: bool = False     # device serve metric planes (pool only)
    recode_budget: Optional[int] = None  # None: full recode; -1: never
    page: int = 0               # tokens per page; 0 -> cfg.kv_page
    pool_pages: int = 0         # physical pool size; 0 -> 2x working set


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _wants_pool(cfg: ModelConfig) -> bool:
    return (cfg.kv_banks > 0 and cfg.family in ("dense", "moe")
            and not cfg.is_encdec and cfg.sliding_window == 0
            and cfg.frontend == "none")


class Server:
    """Continuous-batching server on ``device`` (the CUDA card unless the
    caller names another; no card raises). ``params`` is a tree from
    ``lm.init_params`` or ``convert.params_from_jax`` on any device; it is
    cast to the compute dtype and moved to ``device`` once, here."""

    def __init__(self, cfg: ModelConfig, sc: ServeConfig, params, *,
                 device=None, clock=None):
        self.device = resolve_device(device)
        lm.check_slice(cfg)
        for w in (cfg.sliding_window, cfg.local_window):
            if w > sc.max_prompt:
                # prefill and decode caches must agree on the ring slots
                raise ValueError(f"window {w} exceeds max_prompt "
                                 f"{sc.max_prompt}")
        self.n_patches = cfg.n_patches \
            if cfg.frontend == "vision_stub" else 0
        if self.n_patches > sc.max_prompt:
            # the patches fill the (left-padded) prompt's first positions
            raise ValueError(f"{cfg.name}: max_prompt {sc.max_prompt} is "
                             f"below its {self.n_patches} patch positions")
        self.cfg, self.sc = cfg, sc
        # an encoder-decoder's frames at admission: JAX's Server's shape
        self.n_frames = max(cfg.enc_frames, 8) if cfg.is_encdec else 0
        self.params = lm.cast_params(cfg, params, self.device)
        self.prefill = steps_mod.make_prefill_step(cfg)
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * sc.n_slots
        self.log = obs_serve.ServeLog(clock=clock)
        b = sc.n_slots
        self.pooled = _wants_pool(cfg)
        if self.pooled:
            page = sc.page or cfg.kv_page
            mp = -(-sc.max_seq // page)
            need = b * mp
            pool_pages = sc.pool_pages or -(-2 * need // cfg.kv_banks) \
                * cfg.kv_banks
            if pool_pages % cfg.kv_banks or pool_pages < need:
                raise ValueError(f"pool of {pool_pages} pages: needs a "
                                 f"multiple of {cfg.kv_banks} banks and >= "
                                 f"{need} pages")
            self.kvcfg = kb.KVBankConfig(n_banks=cfg.kv_banks, page=page,
                                         pool_pages=pool_pages, max_pages=mp)
            pool = kb.pool_init(self.kvcfg, cfg.n_layers, b, cfg.n_kv,
                                cfg.head_dim,
                                getattr(torch, cfg.compute_dtype),
                                device=self.device, coded=sc.coded)
            tele = (obs_serve.init_serve_telemetry(cfg.kv_banks, self.device)
                    if sc.telemetry else None)
            self.cache: Dict[str, Any] = {"pool": pool, "tele": tele}
            self.free_pages: List[int] = list(range(pool_pages))
            self.slot_pages: List[List[int]] = [[] for _ in range(b)]
            self.decode = steps_mod.make_pooled_serve_step(
                cfg, self.kvcfg, recode_budget=sc.recode_budget)
            # encode-on-write at install matches the fused decode path (the
            # status table still goes stale-then-fresh identically)
            self._fuse = sc.coded and sc.recode_budget is None
        else:
            self.decode = steps_mod.make_serve_step(cfg)
            self.cache = lm.cache_spec(cfg, b, sc.max_seq, self.device,
                                       enc_frames=self.n_frames)
        self.tokens = torch.zeros(b, dtype=torch.int64, device=self.device)
        self.steps_run = 0

    # ------------------------------------------------------------- admission
    def submit(self, req: Request):
        self.log.submit(req.rid)
        self.queue.append(req)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = req.prompt[-self.sc.max_prompt:]
            self.log.admit(req.rid, i, len(prompt))
            pad = self.sc.max_prompt - len(prompt)
            toks = torch.tensor([[0] * pad + prompt], dtype=torch.int64,
                                device=self.device)
            cd = getattr(torch, self.cfg.compute_dtype)
            patches, extra = None, {}
            if self.n_patches:
                patches = torch.zeros(1, self.n_patches, self.cfg.d_model,
                                      dtype=cd, device=self.device)
            if self.n_frames:
                extra["frames"] = torch.zeros(1, self.n_frames,
                                              self.cfg.d_model, dtype=cd,
                                              device=self.device)
            tok, cache1 = self.prefill(self.params, toks, patches, **extra)
            self._install(i, tok, cache1)
            req.out.append(int(tok[0]))
            self.log.prefill_done(req.rid)
            self.slots[i] = req

    def _install(self, i: int, tok, cache1):
        if self.pooled:
            self._install_pooled(i, tok, cache1)
        else:
            self._install_ring(i, tok, cache1)

    @torch.no_grad()
    def _install_ring(self, i: int, tok, cache1):
        """Copy every leaf of a 1-batch prefill cache into slot i of the
        ring cache, in place: ``pos`` (B,), and the (layers, B, ...)
        leaves (``k``/``v``, ``ssm.conv``/``ssm.state``, ``rg.conv``/
        ``rg.h``, ``xk``/``xv``), each zero-padded to the slot's
        capacity. The batch axis is always axis 1 of a layer-stacked
        leaf, also for a stack of one layer (the JAX ``Server`` guesses
        it from the shapes there, and guesses wrong: its install of slot
        i >= 1 is dropped)."""
        _put_slot(self.cache, cache1, i)
        self.tokens[i] = tok[0]

    @torch.no_grad()
    def _install_pooled(self, i: int, tok, cache1):
        """Assign pool pages to slot i and install the prefilled KV."""
        need = self.kvcfg.max_pages
        if len(self.free_pages) < need:
            raise RuntimeError("pool sized below the working set")
        phys = [self.free_pages.pop(0) for _ in range(need)]
        pool = self.cache["pool"]
        pool.page_table[i] = torch.tensor(phys, dtype=torch.int32)
        kb.pool_install(self.kvcfg, pool, i, cache1["k"][:, 0],
                        cache1["v"][:, 0], fuse_encode=self._fuse)
        self.slot_pages[i] = phys
        self.tokens[i] = tok[0]

    def _retire(self, i: int):
        if not self.pooled:
            return
        self.free_pages.extend(self.slot_pages[i])
        self.slot_pages[i] = []
        pool = self.cache["pool"]
        pool.page_table[i] = -1
        pool.length[i] = 0

    # ----------------------------------------------------------------- step
    def step(self):
        self._admit()
        self.step_decode()

    def step_decode(self):
        """One batched decode step (no admission)."""
        if not any(s is not None for s in self.slots):
            return
        self.tokens, self.cache = self.decode(self.params, self.tokens,
                                              self.cache)
        self.steps_run += 1
        toks = self.tokens.tolist()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            t = toks[i]
            req.out.append(t)
            self.log.token(req.rid)
            if (self.sc.eos_id >= 0 and t == self.sc.eos_id) or \
               len(req.out) >= self.sc.max_new_tokens:
                req.done = True
                self.log.finish(req.rid)
                self.slots[i] = None
                self._retire(i)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            self.step()
            if not self.queue and all(s is None for s in self.slots):
                break

    # ------------------------------------------------------------ telemetry
    def serve_snapshot(self) -> Optional[obs_serve.ServeSnapshot]:
        """Host view of the device serve planes (None when telemetry is
        off or the server runs the ring cache)."""
        tele = self.cache.get("tele") if self.pooled else None
        return None if tele is None else obs_serve.snapshot(tele)

    # ------------------------------------------------------------ placement
    @torch.no_grad()
    def permute_pool(self, perm):
        """Relocate physical pages (placement churn / defrag model): page p
        moves to ``perm[p]``; tables, free list and parity follow, so decode
        output is invariant."""
        if not self.pooled:
            raise ValueError("permute_pool needs the paged pool backend")
        perm = np.asarray(perm)
        kb.pool_permute(self.kvcfg, self.cache["pool"],
                        torch.as_tensor(perm, dtype=torch.int64,
                                        device=self.device))
        self.free_pages = [int(perm[p]) for p in self.free_pages]
        self.slot_pages = [[int(perm[p]) for p in pp]
                           for pp in self.slot_pages]

    # -------------------------------------------------------- fault recovery
    def snapshot(self) -> Dict[str, Any]:
        """The server state as host numpy arrays and lists: a copy, which
        later steps (which update the pool in place) do not alter."""
        snap = {
            "cache": _to_host(self.cache),
            "tokens": _to_host(self.tokens),
            "slots": [(r.rid, list(r.prompt), list(r.out)) if r else None
                      for r in self.slots],
        }
        if self.pooled:
            snap["free_pages"] = list(self.free_pages)
            snap["slot_pages"] = [list(p) for p in self.slot_pages]
        return snap

    def restore_snapshot(self, snap: Dict[str, Any]):
        """Take over a snapshot (from this server or another, on any
        device): fresh tensors on this server's device."""
        self.cache = _from_host(self.cache, snap["cache"], self.device)
        self.tokens = _from_host(self.tokens, snap["tokens"], self.device)
        self.slots = [Request(rid=s[0], prompt=list(s[1]), out=list(s[2]))
                      if s else None for s in snap["slots"]]
        if self.pooled:
            self.free_pages = list(snap["free_pages"])
            self.slot_pages = [list(p) for p in snap["slot_pages"]]


def _put_slot(dst, src, i: int) -> None:
    """``src``'s batch-1 leaves into slot ``i`` of ``dst``'s (a cache
    tree of dicts and NamedTuples)."""
    if isinstance(dst, dict):
        for k in dst:
            _put_slot(dst[k], src[k], i)
    elif isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _put_slot(d, s_, i)
    elif dst.dim() == 1:
        dst[i] = src[0]
    else:
        if tuple(src.shape[2:]) != tuple(dst.shape[2:]):
            dst[:, i] = 0
        dst[(slice(None), i) + tuple(slice(0, n) for n in src.shape[2:])] \
            = src[:, 0]


def _to_host(x):
    """Tensors of a cache tree as numpy copies (bf16 as its int16 bits),
    the pool and the planes (and the recurrent caches) as dicts of their
    fields."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().copy()
    if isinstance(x, kb.PooledKV):
        return {f.name: _to_host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple):            # a NamedTuple
        return {k: _to_host(v) for k, v in x._asdict().items()}
    return {k: _to_host(v) for k, v in x.items()}


def _from_host(like, host, device):
    """Rebuild a tree shaped like ``like`` from ``_to_host`` output, as
    fresh tensors on ``device`` with ``like``'s dtypes."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(host)).to(device)
        return t.view(like.dtype) if t.dtype != like.dtype else t
    if isinstance(like, kb.PooledKV):
        return kb.PooledKV(**{f.name: _from_host(getattr(like, f.name),
                                                 host[f.name], device)
                              for f in dataclasses.fields(like)})
    if isinstance(like, tuple):         # a NamedTuple
        return type(like)(**{k: _from_host(v, host[k], device)
                             for k, v in like._asdict().items()})
    return {k: _from_host(v, host[k], device) for k, v in like.items()}
