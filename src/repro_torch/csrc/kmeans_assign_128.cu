// Build unit of the nearest-centroid assignment kernel (kmeans_assign.cuh),
// which replaces the TPU kernel `_assign_kernel` / `kmeans_assign_padded`
// in src/repro/kernels/kmeans_assign/kmeans_assign.py: the interleaved dot
// order at 64 < d <= 128, in one instantiation of width 128 (the costliest
// to build: a unit of its own, built at once with the others).

#include "kmeans_assign.cuh"

namespace {

Launch pick(int d, bool chain) {
  if (chain || d <= 64 || d > 128) return nullptr;
  return launch<128, false>;
}

}  // namespace
