// One warp's argmin over one query's candidate row, shared by
// nn_search_grid.cu (the candidate sweep) and fused_icp.cu (the fused moment
// pass).
//
// A query's candidates are one contiguous row of CK (x, y, z) fp32 triples
// of the (rows, CK, 3) candidate matrix. Lane l visits slots l, l + 32, ...
// in ascending order, so the 32 lanes read 384 neighbouring bytes at a time.
// d² is the direct form (qx-cx)² + (qy-cy)² + (qz-cz)² summed left to right
// with round-to-nearest intrinsics, which nvcc never contracts into FMAs:
// the plain PyTorch version (kernels/ref.py::candidate_sweep) computes the
// same bits. Each lane keeps its first minimum (strict <); the butterfly
// reduction then takes the lower slot among equal d², so the winner is the
// lowest slot reaching the minimum, as torch.min and the TPU kernel's
// strict < across tiles with argmin within a tile give it.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace fpps {

constexpr unsigned kFullMask = 0xffffffffu;

struct SlotMin {
  float d2;
  int slot;
};

__device__ __forceinline__ float direct_d2(float qx, float qy, float qz,
                                           const float* c) {
  const float dx = __fsub_rn(qx, c[0]);
  const float dy = __fsub_rn(qy, c[1]);
  const float dz = __fsub_rn(qz, c[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Butterfly over the warp's per-lane minima: every lane returns the least
// d², and the lowest slot among equal d². Every lane must call it.
__device__ __forceinline__ SlotMin warp_min(SlotMin best) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float d2 = __shfl_xor_sync(kFullMask, best.d2, offset);
    const int slot = __shfl_xor_sync(kFullMask, best.slot, offset);
    if (d2 < best.d2 || (d2 == best.d2 && slot < best.slot)) {
      best.d2 = d2;
      best.slot = slot;
    }
  }
  return best;
}

// Every lane of the warp must call this; all lanes return the result.
// A lane that sees no slot (CK < 32) carries (+inf, 0); candidate rows are
// finite (masked slots hold 1e15), so such a lane never wins.
__device__ __forceinline__ SlotMin warp_argmin(const float* __restrict__ row,
                                               int ck, float qx, float qy,
                                               float qz, int lane) {
  SlotMin best{__int_as_float(0x7f800000), 0};
  for (int s = lane; s < ck; s += 32) {
    const float d2 = direct_d2(qx, qy, qz, row + 3 * static_cast<size_t>(s));
    if (d2 < best.d2) {
      best.d2 = d2;
      best.slot = s;
    }
  }
  return warp_min(best);
}

}  // namespace fpps
