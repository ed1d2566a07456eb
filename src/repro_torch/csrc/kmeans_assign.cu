// Build unit of the nearest-centroid assignment kernel (kmeans_assign.cuh),
// which replaces the TPU kernel `_assign_kernel` / `kmeans_assign_padded`
// in src/repro/kernels/kmeans_assign/kmeans_assign.py: the one-chain dot
// order at d <= 40, and the interleaved orders at d <= 48, the main path's
// fits among them (d = 15 and 38). kmeans_assign_tiled.cu, which streams
// the depth instead of holding a row in registers, serves every order at
// every width: everything above d = 48 (where it is faster than wider
// instantiations of this kernel were, which spilled), the one chain above
// d = 40, and the one-centroid orders. The instantiations are most of this
// unit's build (its time grows about as the square of the width); the two
// units build at once. The wrapper launches through the first unit that
// serves a launch's order and width (`kmeans_assign_serves`,
// kernels/kmeans_assign/ops.py).

#include "kmeans_assign.cuh"

namespace {

// The interleaved order (four chains, or two) takes the instantiation of
// d's own ceil4 (its tail sits in the last 4 columns). The one-chain order
// reads a point's d columns under run-time guards, so any DMAX >= d serves
// it: it is built at 16 and 40 only (the port's figure fits have d <= 38),
// which keeps the build short; kmeans_assign_tiled.cu serves the one chain
// above d = 40.
// Each interleaved instantiation also serves the swapped interleave (a
// run-time flag).
Launch pick(int d, bool chain) {
  if (chain) {
    if (d <= 16) return launch<16, true>;
    if (d <= 40) return launch<40, true>;
    return nullptr;
  }
  switch ((d + 3) / 4) {
#define KMEANS_ASSIGN_CASE(q) \
  case q:                     \
    return launch<4 * q, false>;
    KMEANS_ASSIGN_CASE(1) KMEANS_ASSIGN_CASE(2) KMEANS_ASSIGN_CASE(3)
    KMEANS_ASSIGN_CASE(4) KMEANS_ASSIGN_CASE(5) KMEANS_ASSIGN_CASE(6)
    KMEANS_ASSIGN_CASE(7) KMEANS_ASSIGN_CASE(8) KMEANS_ASSIGN_CASE(9)
    KMEANS_ASSIGN_CASE(10) KMEANS_ASSIGN_CASE(11) KMEANS_ASSIGN_CASE(12)
#undef KMEANS_ASSIGN_CASE
  }
  return nullptr;
}

}  // namespace
