"""Causal flash attention with GQA (CUDA kernel + plain version)."""
