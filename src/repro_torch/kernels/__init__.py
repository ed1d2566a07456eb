"""Hand-written CUDA kernels of the port, one subpackage each.

Each subpackage mirrors ``repro.kernels.<name>``: ``ops.py`` holds the
public wrapper (routing, shape checks, launch counter, ``last_dispatch``)
and ``ref.py`` the plain PyTorch version the CPU runs and the card's
checks compare against. The CUDA sources live in ``../csrc``; the routing
and build rules are in ``backend.py``.
"""
