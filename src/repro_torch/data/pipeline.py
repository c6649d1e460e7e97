"""Deterministic synthetic token pipeline: the port's own copy of
``repro.data.pipeline`` (NumPy only), bit for bit.

Design goals (what a production input pipeline must provide, scaled down to
a synthetic source):

  * **Determinism & restartability** — ``make_batch(step)`` is a pure
    function of ``(seed, step, host_id)``. After a restart from step k the
    stream continues bit-identically; no iterator state to checkpoint.
  * **Host sharding** — each host materializes only its
    ``global_batch / n_hosts`` slice (the arrays fed to jit carry the global
    batch dimension only logically; here on one host we build the full batch
    for simplicity when n_hosts == 1).
  * **Prefetch** — a double-buffered background thread overlaps host batch
    synthesis with device compute.

The token source is a noisy affine Markov chain over an effective vocab:
``x[t+1] = (a * x[t] + b + eps) mod V_eff`` with P(eps != 0) = noise. An LM
can learn it quickly (loss → the noise entropy), which gives the end-to-end
training example a verifiable learning signal.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int                 # global batch (sequences per step)
    seq_len: int
    seed: int = 0
    noise: float = 0.1         # P(next token is uniform-random)
    v_eff: int = 0             # effective vocab of the chain (0 = min(V, 4096))
    n_hosts: int = 1
    host_id: int = 0


def _chain_params(seed: int, v_eff: int):
    rng = np.random.default_rng(seed ^ 0x5EED)
    # multiplier coprime with v_eff so the chain cycles through the vocab
    a = int(rng.integers(3, max(v_eff - 1, 4)) | 1)
    while np.gcd(a, v_eff) != 1:
        a += 2
    b = int(rng.integers(1, v_eff))
    return a, b


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function (cfg, step) -> {"tokens": (local_batch, seq_len) int32}."""
    v_eff = cfg.v_eff or min(cfg.vocab, 4096)
    a, b = _chain_params(cfg.seed, v_eff)
    local = cfg.batch // cfg.n_hosts
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 131 + cfg.host_id
    )
    x = np.empty((local, cfg.seq_len), np.int64)
    x[:, 0] = rng.integers(0, v_eff, local)
    noise_mask = rng.random((local, cfg.seq_len)) < cfg.noise
    noise_tok = rng.integers(0, v_eff, (local, cfg.seq_len))
    for t in range(1, cfg.seq_len):
        nxt = (a * x[:, t - 1] + b) % v_eff
        x[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
    return {"tokens": x.astype(np.int32)}


class TokenStream:
    """Stateless stream facade: ``stream[step]`` or iteration from ``start``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def __getitem__(self, step: int) -> Dict[str, np.ndarray]:
        return make_batch(self.cfg, step)

    def iterate(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start
        while True:
            yield make_batch(self.cfg, step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch over a TokenStream.

    ``get(step)`` returns the batch for ``step`` and kicks off synthesis of
    ``step+1`` in the background. Out-of-order access (restart) is handled by
    discarding the stale buffer — determinism comes from make_batch purity.
    """

    def __init__(self, stream: TokenStream, depth: int = 2):
        self.stream = stream
        self.depth = depth
        self._q: "queue.Queue[tuple[int, Dict[str, np.ndarray]]]" = queue.Queue(depth)
        self._next = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _worker(self, start: int):
        step = start
        while not self._stop.is_set():
            batch = self.stream[step]
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, step: int = 0):
        self.stop()
        self._stop.clear()
        self._q = queue.Queue(self.depth)
        self._next = step
        self._thread = threading.Thread(target=self._worker, args=(step,), daemon=True)
        self._thread.start()

    def get(self, step: int) -> Dict[str, np.ndarray]:
        if self._thread is None or step != self._next:
            self.start(step)                     # restart / random access
        got_step, batch = self._q.get()
        assert got_step == step, (got_step, step)
        self._next = step + 1
        return batch

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None
