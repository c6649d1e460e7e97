"""Static invariant verification of the port (``repro.analysis``
counterpart): three static layers, one CLI (``python -m
repro_torch.analysis``), and the runtime recompile guard.

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
* ``repro_torch.analysis.guard`` — ``recompile_guard``, the runtime
  complement: a region fails if it built a kernel library (an ``nvcc``
  run of ``kernels.build``) it did not budget for. CUDA-graph captures
  join its ``GUARDED`` targets when a later change adds graphs.
"""
from repro_torch.analysis.base import Finding, format_findings

__all__ = ["Finding", "format_findings"]
