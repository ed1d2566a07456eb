"""Batch-native nearest-centroid assignment (CUDA kernel + plain version)."""
