"""Static invariant verification of the port (``repro.analysis``
counterpart): three layers, one CLI (``python -m repro_torch.analysis``).

* ``repro_torch.analysis.schemes`` — GF(2) proofs over every scheme of
  ``repro_torch.core.codes`` and the serving pool's pairwise layout
  (``runtime.kvbank.parity_members``): erasure tolerance, read degree,
  locality, stride aliasing, and the certificate document
  (``certificates.json``, equal to the JAX package's).
* ``repro_torch.analysis.carry`` — the counterpart of JAX's jaxpr lint,
  on live objects: signature completeness, carry stability, flag-off
  identity (ATen op sequences under a ``TorchDispatchMode``).
* ``repro_torch.analysis.rules`` — AST lint of the port's rules: oracle
  purity, port isolation, static geometry, wide counters, host syncs in
  device code, no silent fallback to a plain version.

JAX's ``guard.py`` (``recompile_guard``) has no counterpart yet: in the
port it would count CUDA-graph captures, and the port captures none
before ROADMAP queue 1 item 3's graphs.
"""
from repro_torch.analysis.base import Finding, format_findings

__all__ = ["Finding", "format_findings"]
