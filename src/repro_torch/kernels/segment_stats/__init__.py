"""Batch-native per-segment statistics (CUDA kernel + plain version)."""
