"""PyTorch + CUDA port of the two-phase stratified CPU-simulation
sampling system, for one NVIDIA H100.

It mirrors the reference package ``repro`` module for module and never
imports it or JAX. Entry points run on the card unless the caller names
another device (``ExperimentEngine(device="cpu")``); the hand-written
kernels live in ``repro_torch.kernels`` with their CUDA sources in
``csrc/``.
"""
