"""Bounded rolling-window trace sources for streaming replay, port of
``repro/traces/source.py``.

``stream_replay`` consumes a ``TraceSource``: per-core request streams with
bounded random access. Each replay step stages a fixed-shape buffer of the
next ``chunk_len`` requests per core, from each core's own position (cores
drain at different rates, so the window is ragged across cores). The
source keeps only the columns between the slowest core's position and the
fastest core's position plus one stage, so host memory is
``O(core spread + chunk_len)`` columns whatever the trace's length.

Chunks come lazily from an iterator, pulled on a background thread two
ahead (``_ChunkPrefetcher``), so parsing a file overlaps the card's replay
of the current chunk. The window is numpy on the host; the thread never
touches CUDA: it only pulls chunks (the port's own chunk iterators,
``chunk_iter`` and ``formats.stream_file``, yield numpy arrays), and the
chunks become numpy on the consumer's thread. ``stage`` builds the staging
buffer in numpy and moves it to the device on the caller's thread in one
host-to-device copy.
"""
from __future__ import annotations

import queue
import threading
import time
import types
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.state import INT32_MAX
from repro_torch.core.system import Trace
from repro_torch.kernels.common import resolve_device

_DTYPES = (np.int32, np.int32, bool, np.int32, bool)   # Trace's fields


def host_arrays(trace: Trace) -> list:
    """The five fields of ``trace`` (tensors on any device, or arrays) as
    numpy arrays."""
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in trace]


def _pull_retry(it: Iterator[Trace], retries: int,
                backoff: float) -> Optional[Trace]:
    """``next(it, None)`` with bounded retry on transient read errors.

    A flaky source gets ``retries`` extra attempts with exponential backoff
    before the exception propagates. Only ``Exception`` retries, and never
    on a generator: one is dead after raising, and retrying ``next()`` on
    it yields ``StopIteration``, which would silently truncate the stream.
    The budget is per pull, so a source that recovers starts afresh on the
    next chunk."""
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return next(it, None)
        except Exception:
            if attempt == retries or isinstance(it, types.GeneratorType):
                raise
            time.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable")


class _ChunkPrefetcher:
    """Pull chunks from an iterator on a background thread (depth 2).

    An exception inside the iterator is captured and re-raised from
    ``next()`` on the consumer's thread: a failed ingest fails the replay,
    it does not pass for a short stream."""

    _SENTINEL = object()

    def __init__(self, it: Iterator[Trace], depth: int = 2,
                 retries: int = 0, backoff: float = 0.05):
        self._q: "queue.Queue" = queue.Queue(depth)
        self._err: Optional[BaseException] = None
        self._retries = int(retries)
        self._backoff = float(backoff)
        self._thread = threading.Thread(
            target=self._worker, args=(it,), daemon=True)
        self._thread.start()

    def _worker(self, it: Iterator[Trace]):
        try:
            while True:
                chunk = _pull_retry(it, self._retries, self._backoff)
                if chunk is None:
                    break
                self._q.put(chunk)
        except BaseException as e:              # noqa: BLE001 — relayed
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def next(self) -> Optional[Trace]:
        got = self._q.get()
        if got is self._SENTINEL and self._err is not None:
            raise self._err
        return None if got is self._SENTINEL else got


class TraceSource:
    """Rolling window over per-core request streams.

    Build with :meth:`from_trace` (in memory, total length known) or
    :meth:`from_chunks` (a lazy iterator of ``Trace`` chunks, of numpy
    arrays or tensors, concatenated along time; the total length is known
    once the iterator ends). All chunks share ``n_cores``.
    """

    def __init__(self, chunks: Iterator[Trace], n_cores: Optional[int] = None,
                 prefetch: bool = True, retries: int = 0,
                 backoff: float = 0.05):
        self._fetch: Union[_ChunkPrefetcher, Iterator[Trace], None]
        it = iter(chunks)
        self._retries = int(retries)
        self._backoff = float(backoff)
        self._fetch = (_ChunkPrefetcher(it, retries=self._retries,
                                        backoff=self._backoff)
                       if prefetch else it)
        self.n_cores = n_cores
        self._buf: Optional[list] = None   # 5 (n_cores, W) numpy arrays
        self.base = 0                      # global index of buffer column 0
        self.total: Optional[int] = None   # per-core length once known

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_trace(cls, trace: Trace) -> "TraceSource":
        src = cls(iter(()), prefetch=False)
        src._append(trace)
        src._fetch = None
        src.total = src._buffered_end()
        return src

    @classmethod
    def from_chunks(cls, chunks: Iterable[Trace], prefetch: bool = True,
                    retries: int = 0, backoff: float = 0.05) -> "TraceSource":
        """Lazy source over an iterator of ``Trace`` chunks; ``retries`` /
        ``backoff`` give each pull a bounded exponential-backoff budget
        against transient read errors (``_pull_retry``)."""
        return cls(iter(chunks), prefetch=prefetch, retries=retries,
                   backoff=backoff)

    # -------------------------------------------------------------- ingestion
    def _append(self, chunk: Trace):
        arrs = host_arrays(chunk)
        if self.n_cores is None:
            self.n_cores = arrs[0].shape[0]
        if arrs[0].shape[0] != self.n_cores:
            raise ValueError(
                f"chunk has {arrs[0].shape[0]} cores, stream has {self.n_cores}")
        if self._buf is None:
            self._buf = arrs
        else:
            self._buf = [np.concatenate([a, b], axis=1)
                         for a, b in zip(self._buf, arrs)]

    def _buffered_end(self) -> int:
        return self.base + (self._buf[0].shape[1] if self._buf is not None else 0)

    def _pull_one(self) -> bool:
        if self._fetch is None:
            return False
        chunk = (self._fetch.next() if isinstance(self._fetch, _ChunkPrefetcher)
                 else _pull_retry(self._fetch, self._retries, self._backoff))
        if chunk is None:
            self._fetch = None
            self.total = self._buffered_end()
            return False
        self._append(chunk)
        return True

    def _fill_to(self, upto: int):
        while self._buffered_end() < upto and self._pull_one():
            pass

    def _trim(self, min_pos: int):
        drop = min_pos - self.base
        if drop > 0 and self._buf is not None:
            self._buf = [a[:, drop:] for a in self._buf]
            self.base = min_pos

    # ---------------------------------------------------------------- staging
    def stage(self, positions: np.ndarray, chunk_len: int,
              device=None) -> Tuple[Trace, torch.Tensor]:
        """Fixed-shape staging buffer for the next replay step, on
        ``device`` (the card unless named).

        Returns ``(chunk, stream_end)``: ``chunk`` holds each core's
        ``chunk_len`` requests from ``positions[core]`` (cells past the
        stream end are invalid, and ``stream_end`` stops the pointer before
        them); ``stream_end[c]`` is the count of real staged requests when
        core ``c``'s stream ends inside the buffer, else INT32_MAX ("more
        behind the buffer"). Everything crosses to the device as one int32
        block."""
        trace, stream_end = stage_batch([self], np.asarray(positions)[None],
                                        chunk_len, device)
        return Trace(*(x[0] for x in trace)), stream_end[0]

    def _stage_block(self, positions: np.ndarray,
                     chunk_len: int) -> np.ndarray:
        """The staging buffer as one host int32 block: the five trace
        fields (n_cores, chunk_len) raveled, then ``stream_end``."""
        positions = np.asarray(positions, np.int64)
        self._fill_to(int(positions.max()) + chunk_len)
        self._trim(int(positions.min()))
        if self._buf is None:                       # empty stream
            if self.n_cores is None:
                raise ValueError("empty chunk stream with unknown n_cores")
            self._buf = [np.zeros((self.n_cores, 0), d) for d in _DTYPES]
        width = self._buf[0].shape[1]
        idx = positions[:, None] + np.arange(chunk_len) - self.base
        inb = idx < width
        take = np.minimum(np.maximum(idx, 0), max(width - 1, 0))
        out = [np.take_along_axis(a, take, axis=1) if width else
               np.zeros((self.n_cores, chunk_len), a.dtype) for a in self._buf]
        out[4] = out[4] & inb                       # valid &= in-buffer
        if self.total is None:
            stream_end = np.full((self.n_cores,), INT32_MAX, np.int32)
        else:
            remaining = self.total - positions
            stream_end = np.where(remaining <= chunk_len, remaining,
                                  INT32_MAX).astype(np.int32)
        return np.concatenate([a.astype(np.int32).ravel() for a in out]
                              + [stream_end])

    def exhausted(self, positions: np.ndarray) -> bool:
        """True once every core's position has passed the stream end."""
        return (self.total is not None
                and bool((np.asarray(positions) >= self.total).all()))


def as_source(source) -> TraceSource:
    """Coerce a Trace, an iterable of Trace chunks, or a TraceSource."""
    if isinstance(source, TraceSource):
        return source
    if isinstance(source, Trace):
        return TraceSource.from_trace(source)
    return TraceSource.from_chunks(source)


def chunk_iter(trace: Trace, chunk_len: int) -> Iterator[Trace]:
    """Slice a trace into time-axis chunks of numpy arrays (testing and
    benching). The trace is read to the host here, on the caller's thread,
    so a prefetch thread pulling the chunks never touches the card."""
    arrs = host_arrays(trace)

    def chunks():
        for off in range(0, arrs[0].shape[1], chunk_len):
            yield Trace(*(a[:, off:off + chunk_len] for a in arrs))

    return chunks()


def stage_batch(sources, positions: np.ndarray, chunk_len: int,
                device=None) -> Tuple[Trace, torch.Tensor]:
    """``TraceSource.stage`` for B points at once: ``positions`` (B,
    n_cores), the sources sharing ``n_cores``. Returns the chunks as one
    ``Trace`` of (B, n_cores, chunk_len) fields and ``stream_end`` (B,
    n_cores) on ``device``, with one host-to-device copy."""
    dev = resolve_device(device)
    blocks = np.stack([src._stage_block(pos, chunk_len)
                       for src, pos in zip(sources, positions)])
    block = torch.from_numpy(blocks).to(dev)
    B, nc = len(blocks), sources[0].n_cores
    n = nc * chunk_len
    cols = [block[:, f * n:(f + 1) * n].view(B, nc, chunk_len)
            for f in range(5)]
    chunk = Trace(bank=cols[0], row=cols[1], is_write=cols[2].bool(),
                  data=cols[3], valid=cols[4].bool())
    return chunk, block[:, 5 * n:]
