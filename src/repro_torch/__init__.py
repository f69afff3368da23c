"""PyTorch / CUDA port of the multi-Krum / multi-Bulyan system (arXiv 1905.04374).

The JAX package ``repro`` is the reference; this package keeps its module
names (``core``, ``kernels``, ``models``, ``dist``, ...) so each counterpart
is easy to find.  It imports ``torch`` and numpy only.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the two stats and apply
kernels of the main path are hand-written CUDA for Hopper (``csrc/``), and
each has a plain PyTorch version in ``kernels/ref.py``.
"""
