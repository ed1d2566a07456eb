// Build unit of the nearest-centroid assignment kernel (kmeans_assign.cuh),
// which replaces the TPU kernel `_assign_kernel` / `kmeans_assign_padded`
// in src/repro/kernels/kmeans_assign/kmeans_assign.py: the interleaved dot
// order at 48 < d <= 64 (kmeans_assign.cu and kmeans_assign_128.cu build
// the rest, at once).

#include "kmeans_assign.cuh"

namespace {

Launch pick(int d, bool chain) {
  if (chain) return nullptr;
  switch ((d + 3) / 4) {
#define KMEANS_ASSIGN_CASE(q) \
  case q:                     \
    return launch<4 * q, false>;
    KMEANS_ASSIGN_CASE(13) KMEANS_ASSIGN_CASE(14) KMEANS_ASSIGN_CASE(15)
    KMEANS_ASSIGN_CASE(16)
#undef KMEANS_ASSIGN_CASE
  }
  return nullptr;
}

}  // namespace
