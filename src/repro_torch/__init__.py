"""PyTorch/CUDA port of the coded multi-port memory system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``kernels``, ``models``, ``runtime``, ``obs``,
``launch``) and imports nothing of it. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; on the card every ported TPU
kernel is a hand-written Hopper kernel under ``csrc/``.
"""
