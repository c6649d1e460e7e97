"""External DRAM-trace ingestion: Ramulator / gem5 text formats and .npz,
port of ``repro/traces/formats.py``.

Three on-disk forms become the ``Trace`` the cycle engine consumes:

* **Ramulator-style** (``.trace``): one request per line, ``<addr> <R|W>``
  (either order; ``R/W/RD/WR/READ/WRITE``; hex ``0x…`` or decimal
  addresses). ``#`` comments and blank lines are skipped.
* **gem5-style** (``.gem5``/CSV): ``tick,cmd,addr[,size]`` rows, ``cmd`` in
  {r, w} (any case; whitespace-separated variants accepted), in file order.
* **``.npz``**: the five ``Trace`` arrays (``bank``, ``row``, ``is_write``,
  ``data``, ``valid``; each ``(n_cores, T)``) saved verbatim.

Byte addresses become row addresses by ``addr // line_bytes`` and the
low-bit bank interleaving of ``repro_torch.sim.trace.addr_to_bank_row``. A
single stream is dealt round-robin across cores in file order: request
``i`` goes to core ``i % n_cores`` at time slot ``i // n_cores``.

Functions that return a ``Trace`` of tensors take ``device`` (the card
unless named); ``stream_file`` yields numpy chunks for a ``TraceSource``'s
prefetch thread, which never touches the card.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.system import Trace
from repro_torch.kernels.common import resolve_device
from repro_torch.sim.trace import addr_to_bank_row
from repro_torch.traces.source import chunk_iter, host_arrays

_READS = {"r", "rd", "read"}
_WRITES = {"w", "wr", "write"}


class TraceFormatError(ValueError):
    """A malformed on-disk trace: truncated line, garbage token, wrong
    column count, corrupt or incomplete ``.npz``. It names the file and,
    for text formats, the 1-based line; it subclasses ``ValueError``."""

    def __init__(self, path: str, line: Optional[int] = None,
                 detail: str = ""):
        loc = f"{path}:{line}" if line is not None else str(path)
        super().__init__(f"{loc}: {detail}")
        self.path = path
        self.line = line


def _parse_int(tok: str) -> Optional[int]:
    try:
        return int(tok, 16) if tok.lower().startswith("0x") else int(tok)
    except ValueError:
        return None


def _parse_op(tok: str) -> Optional[bool]:
    t = tok.lower()
    if t in _WRITES:
        return True
    if t in _READS:
        return False
    return None


def iter_ramulator(path: str) -> Iterator[Tuple[int, bool]]:
    """Lazily yield (addr, is_write) from a Ramulator-style text trace."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            toks = line.split("#", 1)[0].split()
            if not toks:
                continue
            addr = op = None
            for tok in toks:
                if op is None and (v := _parse_op(tok)) is not None:
                    op = v
                elif addr is None and (v := _parse_int(tok)) is not None:
                    addr = v
            if addr is None or op is None:
                raise TraceFormatError(
                    path, ln, f"expected '<addr> <R|W>', got {line!r}")
            yield addr, op


def iter_gem5(path: str) -> Iterator[Tuple[int, bool]]:
    """Lazily yield (addr, is_write) from a gem5-style ``tick,cmd,addr``
    trace (comma- or whitespace-separated, in file order)."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            body = line.split("#", 1)[0].strip()
            if not body:
                continue
            toks = [t for t in body.replace(",", " ").split() if t]
            if len(toks) < 3:
                raise TraceFormatError(
                    path, ln, f"expected 'tick,cmd,addr[,size]', got {line!r}")
            tick, op, addr = (_parse_int(toks[0]), _parse_op(toks[1]),
                              _parse_int(toks[2]))
            if tick is None or op is None or addr is None:
                raise TraceFormatError(
                    path, ln, f"expected 'tick,cmd,addr[,size]', got {line!r}")
            yield addr, op


PARSERS = {"ramulator": iter_ramulator, "gem5": iter_gem5}


def _sniff_format(path: str) -> str:
    """Pick a text parser by extension, else by the first content line."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gem5", ".csv"):
        return "gem5"
    if ext == ".trace":
        return "ramulator"
    with open(path) as f:
        for line in f:
            body = line.split("#", 1)[0].strip()
            if body:
                return "gem5" if ("," in body or len(body.split()) >= 3) \
                    else "ramulator"
    return "ramulator"


def _parser(path: str, format: Optional[str]):
    fmt = format or _sniff_format(path)
    if fmt not in PARSERS:
        raise ValueError(f"unknown trace format {fmt!r}; have {sorted(PARSERS)}")
    return PARSERS[fmt]


def _payloads(addr: np.ndarray, seq: np.ndarray) -> np.ndarray:
    """Deterministic nonzero write payloads: a hash of (address, sequence
    number), since external traces carry no data values."""
    h = (addr.astype(np.uint64) * np.uint64(2654435761)
         + seq.astype(np.uint64) * np.uint64(97)) & np.uint64(0x3FFFFFFF)
    return (h | np.uint64(1)).astype(np.int32)


def _to_device(arrs, device) -> Trace:
    dev = resolve_device(device)
    return Trace(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrs))


def _deal(addrs, is_write, *, n_cores: int, n_banks: int, n_rows: int,
          line_bytes: int, length: Optional[int], seq0: int = 0) -> Trace:
    """``requests_to_trace`` in numpy: a ``Trace`` of numpy arrays whose
    payloads number the requests from ``seq0``."""
    addrs = np.asarray(list(addrs) if not isinstance(addrs, np.ndarray)
                       else addrs, np.int64)
    is_write = np.asarray(list(is_write) if not isinstance(is_write, np.ndarray)
                          else is_write, bool)
    if addrs.shape != is_write.shape:
        raise ValueError("addrs and is_write must align")
    if line_bytes > 1:
        addrs = addrs // line_bytes
    n = addrs.size
    T = length if length is not None else -(-max(n, 1) // n_cores)
    if n > n_cores * T:
        raise ValueError(
            f"length={T} holds at most {n_cores * T} requests over "
            f"{n_cores} cores but the stream has {n} — size the point to "
            f"the file (length ≥ {-(-n // n_cores)}) or replay it chunked "
            f"via stream_file/stream_replay")
    bank = np.zeros((n_cores, T), np.int32)
    row = np.zeros((n_cores, T), np.int32)
    isw = np.zeros((n_cores, T), bool)
    data = np.zeros((n_cores, T), np.int32)
    valid = np.zeros((n_cores, T), bool)
    seq = np.arange(n, dtype=np.int64)
    core, t = seq % n_cores, seq // n_cores
    b, r = addr_to_bank_row(addrs, n_banks, n_rows)
    bank[core, t] = b
    row[core, t] = r
    isw[core, t] = is_write
    data[core, t] = _payloads(addrs, seq + seq0)
    valid[core, t] = True
    return Trace(bank=bank, row=row, is_write=isw, data=data, valid=valid)


def requests_to_trace(addrs, is_write, *, n_cores: int = 8, n_banks: int = 8,
                      n_rows: int = 512, line_bytes: int = 1,
                      length: Optional[int] = None, device=None) -> Trace:
    """Deal a single request stream into the engine's per-core ``Trace``
    on ``device``.

    ``line_bytes`` shifts byte addresses down to line granularity before
    the bank interleaving (1: addresses are already linear request
    addresses). ``length`` pads each core's stream to a fixed T (default:
    just enough slots, the tail padded invalid); a length too small for
    every request raises rather than drop the stream's tail."""
    return _to_device(_deal(addrs, is_write, n_cores=n_cores, n_banks=n_banks,
                            n_rows=n_rows, line_bytes=line_bytes,
                            length=length), device)


def save_npz(path: str, trace: Trace) -> str:
    """The canonical on-disk form: the five Trace arrays, lossless."""
    np.savez_compressed(path, **dict(zip(Trace._fields, host_arrays(trace))))
    return path


def _load_npz_arrays(path: str) -> list:
    try:
        z = np.load(path)
    except OSError:
        raise
    except Exception as e:       # truncated zip, corrupt member, bad pickle
        raise TraceFormatError(path, None,
                               f"not a readable trace .npz ({e})") from e
    with z:
        missing = [k for k in Trace._fields if k not in z]
        if missing:
            raise TraceFormatError(path, None, "not a canonical trace .npz "
                                   f"(missing {missing})")
        try:
            return [np.asarray(z[k]) for k in Trace._fields]
        except Exception as e:   # member present but corrupt/undecodable
            raise TraceFormatError(path, None,
                                   f"corrupt trace .npz ({e})") from e


def load_npz(path: str, device=None) -> Trace:
    """A canonical ``.npz`` trace on ``device``, verbatim."""
    return _to_device(_load_npz_arrays(path), device)


def probe(path: str) -> Tuple[int, int]:
    """(n_cores, length) of an ``.npz`` trace without loading it whole."""
    with np.load(path) as z:
        return tuple(int(d) for d in z["bank"].shape)


def count_requests(path: str, format: Optional[str] = None) -> int:
    """Number of requests in a text trace (one lazy parse)."""
    return sum(1 for _ in _parser(path, format)(path))


def load_trace(path: str, *, format: Optional[str] = None, n_cores: int = 8,
               n_banks: int = 8, n_rows: int = 512, line_bytes: int = 1,
               length: Optional[int] = None, device=None) -> Trace:
    """Any supported on-disk trace as a ``Trace`` on ``device``.

    ``.npz`` loads verbatim (the mapping arguments do not apply). Text
    formats parse lazily and deal round-robin across ``n_cores``;
    ``format`` ("ramulator" | "gem5") pins the parser, else it is sniffed
    from the extension or the first content line."""
    if path.endswith(".npz"):
        return load_npz(path, device)
    reqs = list(_parser(path, format)(path))
    addrs = np.fromiter((a for a, _ in reqs), np.int64, len(reqs))
    is_w = np.fromiter((w for _, w in reqs), bool, len(reqs))
    return requests_to_trace(addrs, is_w, n_cores=n_cores, n_banks=n_banks,
                             n_rows=n_rows, line_bytes=line_bytes,
                             length=length, device=device)


def stream_file(path: str, chunk_len: int, *, format: Optional[str] = None,
                n_cores: int = 8, n_banks: int = 8, n_rows: int = 512,
                line_bytes: int = 1) -> Iterator[Trace]:
    """Lazily read a trace as ``(n_cores, chunk_len)`` chunks of numpy
    arrays (the file never materializes whole); feed it to
    ``stream_replay``, which parses on a background thread. ``.npz`` is
    loaded and sliced."""
    if path.endswith(".npz"):
        yield from chunk_iter(Trace(*_load_npz_arrays(path)), chunk_len)
        return
    it = _parser(path, format)(path)
    per_chunk = n_cores * chunk_len
    base = 0
    while True:
        buf = []
        for req in it:
            buf.append(req)
            if len(buf) == per_chunk:
                break
        if not buf:
            return
        addrs = np.fromiter((a for a, _ in buf), np.int64, len(buf))
        is_w = np.fromiter((w for _, w in buf), bool, len(buf))
        # the tail chunk stays short (ceil(n / n_cores) columns): padding it
        # to chunk_len would add idle columns that only the chunked form
        # has, and the replay would walk them one cycle each
        yield _deal(addrs, is_w, n_cores=n_cores, n_banks=n_banks,
                    n_rows=n_rows, line_bytes=line_bytes,
                    length=-(-len(buf) // n_cores), seq0=base)
        base += len(buf)
        if len(buf) < per_chunk:
            return
