"""Run manifests for the port's artefacts: what produced a result, pinned
in the blob; the port of ``repro/obs/runlog.py``.

Every artefact the port's harnesses write (``experiments/torch/*.json``)
carries a ``manifest`` block: which commit, which torch and CUDA, which
cards (each card's name, and its power limit as ``nvidia-smi`` reports it:
a card set below its maximum runs slower under load), which config
(including the sweep layer's ``static_signature`` when the run came from a
``SweepPoint``), and how long the timed parts took. On a machine without a
CUDA card ``devices`` says so; nothing here needs a card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

MANIFEST_SCHEMA = 1
NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def git_sha(repo_root: Optional[str] = None) -> str:
    """HEAD commit of ``repo_root`` (default: this file's repo), or
    "unknown" outside a git checkout / without a git binary."""
    root = repo_root or os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card_lines() -> List[str]:
    """``name, power.limit`` of each card as ``nvidia-smi`` gives them;
    empty where there is no ``nvidia-smi`` or it fails."""
    try:
        out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_topology() -> Dict[str, Any]:
    """torch's CUDA build, each visible card's name, their count and the
    cards' ``name, power.limit`` lines; ``backend`` is ``"cpu"`` (and the
    count 0) where torch sees no CUDA card."""
    import torch
    # analysis: no-fallback describes the host for a manifest; runs nothing
    if not torch.cuda.is_available():
        return {"backend": "cpu", "n_devices": 0, "device_kinds": [],
                "cuda": torch.version.cuda, "cards": [],
                "note": "no CUDA device visible: a CPU run"}
    n = torch.cuda.device_count()
    names = [torch.cuda.get_device_name(i) for i in range(n)]
    return {"backend": "cuda", "n_devices": n,
            "device_kinds": sorted(set(names)), "cuda": torch.version.cuda,
            "cards": card_lines()}


def _versions() -> Dict[str, str]:
    import numpy
    import torch
    return {"python": platform.python_version(), "torch": torch.__version__,
            "numpy": numpy.__version__}


def point_config(pt) -> Dict[str, Any]:
    """A ``SweepPoint`` as a manifest config block: its coordinates plus the
    engine's batch key (``static_signature``)."""
    from repro_torch.sweep.grid import static_signature
    cfg = dataclasses.asdict(pt)
    cfg["static_signature"] = list(static_signature(pt))
    return cfg


def run_manifest(config: Optional[Any] = None,
                 timings: Optional[Dict[str, float]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The manifest block attached to result artefacts.

    ``config`` may be a ``SweepPoint`` (expanded via ``point_config``), a
    dict, or any JSON-serializable value; ``timings`` holds wall times in
    seconds keyed by phase (e.g. ``grid_s``)."""
    if config is not None and dataclasses.is_dataclass(config) \
            and hasattr(config, "derived_slots"):
        config = point_config(config)
    now = time.time()
    man: Dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": round(now, 3),
        "created_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z",
                                     time.localtime(now)),
        "git_sha": git_sha(),
        "argv": list(sys.argv),
        "versions": _versions(),
        "devices": device_topology(),
    }
    if config is not None:
        man["config"] = config
    if timings:
        man["timings"] = {k: round(float(v), 4) for k, v in timings.items()}
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, **kw) -> str:
    """Standalone manifest file (for artefacts that are not JSON blobs)."""
    man = run_manifest(**kw)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(man, f, indent=1, default=str)
    return path
