"""Atomic, asynchronous checkpoints of a tree of tensors and numpy arrays
(``repro/checkpoint/checkpoint.py`` counterpart): the batched streamed
replay's carry (``repro_torch.traces.stream_replay_points``) and the
trainer's params and optimizer state.

Layout per step, the JAX package's (one host), so either package
restores the other's checkpoints::

    <dir>/step_000123/
        manifest.json        # leaf paths, shapes, dtypes, step, n_hosts
        host_000.npz         # every leaf as a numpy array; bfloat16
                             # leaves as their uint16 bits
    <dir>/step_000123.tmp…   # staging dir, atomically renamed on commit

  * **Atomicity** — a step is written into a fresh staging directory and
    ``os.replace`` to its final name is the commit point, so a killed
    writer never leaves a readable half-checkpoint; ``latest_step`` only
    considers committed directories.
  * **Async** — ``CheckpointManager.save_async`` copies the leaves to host
    memory synchronously (a consistent view), then writes on a background
    thread; ``wait`` joins it and raises what the writer raised.

  * **Retention** — the manager keeps the newest ``keep`` steps.

  * **Re-mesh on restore** — DTensor leaves are saved full
    (``full_tensor()``, a collective every rank joins; rank 0 alone
    writes), so a checkpoint from any mesh, or from either package, has
    the one-host layout; ``restore(..., shardings=)`` distributes each
    full leaf to the target placements, so it restores onto another mesh
    or onto one device (elastic resume).

A tree is nested dicts, tuples, lists and NamedTuples with tensor, array
or None leaves; a leaf's path is its keys joined by ``/`` (a NamedTuple's
field names, a sequence's indices), as JAX names them. ``restore``
rebuilds the structure of a ``like`` tree: tensor leaves come back as
tensors on the ``like`` leaf's device (or on ``device``) and in its
dtype, arrays as arrays. Without ``like`` it rebuilds nested dicts from
the paths, every leaf a tensor on ``device`` in its stored dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _walk(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``tree`` with every tensor or array leaf ``x`` at ``path`` replaced
    by ``fn(path, x)``."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _walk(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, v, _join(path, k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(fn, v, _join(path, i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    raise TypeError(f"checkpoint leaf {path!r}: unsupported {type(tree)}")


def _to_host(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    """(path, stored array, logical dtype) of every leaf: a copy in host
    memory, bfloat16 as its uint16 bits (numpy has no bfloat16)."""
    leaves: List[Tuple[str, np.ndarray, str]] = []

    def take(path, x):
        if hasattr(x, "full_tensor"):        # a DTensor: gather it
            x = x.full_tensor()
        if not isinstance(x, torch.Tensor):
            a = np.array(x)
            leaves.append((path, a, str(a.dtype)))
        elif x.dtype == torch.bfloat16:
            a = x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
            leaves.append((path, a.copy(), "bfloat16"))
        else:
            a = x.detach().cpu().numpy().copy()
            leaves.append((path, a, str(a.dtype)))

    _walk(take, tree)
    return leaves


def _write(step: int, leaves, directory: str) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:09d}.tmp", dir=directory)
    try:
        np.savez(os.path.join(tmp, "host_000.npz"),
                 **{f"leaf_{i:05d}": a for i, (_, a, _) in enumerate(leaves)})
        manifest = {"step": step, "names": [n for n, _, _ in leaves],
                    "shapes": [list(a.shape) for _, a, _ in leaves],
                    "dtypes": [dt for _, _, dt in leaves], "n_hosts": 1}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):            # idempotent re-save
            shutil.rmtree(final)
        os.replace(tmp, final)               # commit point
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the one
    process there is."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save(step: int, tree: Any, directory: str) -> str:
    """Blocking save of ``tree`` as step ``step``; returns the committed
    directory."""
    leaves = _to_host(tree)
    final = os.path.join(directory, f"step_{step:09d}")
    return _write(step, leaves, directory) if _writer() else final


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_STEP_RE.match,
                                          os.listdir(directory))
             if m and os.path.exists(os.path.join(directory, m.group(0),
                                                  "manifest.json"))]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, like: Any = None, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Any:
    """Step ``step`` (default the latest) restored into the structure of
    ``like``, tensors onto ``device`` when it is given (else each onto
    its ``like`` leaf's device); without ``like``, as nested dicts of
    tensors on ``device`` (default the CPU). ``shardings``, a tree of
    ``launch.sharding.NamedSharding`` (or None leaves) like the result,
    distributes each full leaf to its placements: the re-mesh."""
    out = _restore(directory, like, step, device)
    if shardings is None:
        return out
    from repro_torch.launch.sharding import distribute
    return distribute(out, shardings)


def _restore(directory, like, step, device):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "host_000.npz")) as z:
        by_name = {n: (z[f"leaf_{i:05d}"], dt) for i, (n, dt) in
                   enumerate(zip(manifest["names"], manifest["dtypes"]))}

    if like is None:
        out: dict = {}
        for name, (arr, dt) in by_name.items():
            *keys, last = name.split("/")
            node = out
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = _tensor(arr, dt).to(device or "cpu")
        return out

    def load(path, proto):
        if path not in by_name:
            raise KeyError(f"checkpoint {d} has no leaf {path!r}")
        arr, dt = by_name[path]
        if isinstance(proto, torch.Tensor):
            return _tensor(arr, dt).to(device=device or proto.device,
                                       dtype=proto.dtype)
        return arr.astype(proto.dtype, copy=False)

    return _walk(load, like)


class CheckpointManager:
    """Asynchronous writer with retention of the newest ``keep`` steps. One
    save in flight at a time: the next save joins the previous first."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        leaves = _to_host(tree)          # a consistent host copy, now
        if not _writer():
            return

        def work():
            try:
                _write(step, leaves, self.directory)
                self._gc()
            except BaseException as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for m in
                       map(_STEP_RE.match, os.listdir(self.directory)) if m)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
