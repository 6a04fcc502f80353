// Grid-bucketed NN candidate sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/nn_search_grid.py::_grid_nn_kernel
// (called through candidate_sweep_kernel). Same contract: for queries
// q (rows, 3) and their candidate rows cand (rows, CK, 3), fp32, with masked
// slots already at the 1e15 sentinel (core/nn_search_grid.py),
//
//   best_d2[r]   = min_s ||q[r] - cand[r, s]||²    (unclamped, direct form)
//   best_slot[r] = the lowest s reaching it
//
// rows is the whole batch (B * N): one launch serves a frame batch.
//
// Bound on an H100 SXM: every candidate byte is read once and used for ~9
// flops, so the sweep is bound by bytes. At the main path's B=1, N=4096,
// CK=27*32=864 the candidate matrix is 42.5 MB: 0.0127 ms at 3.35 TB/s
// (0.101 ms at B=8); the arithmetic is ~0.5 us.
//
// Design (simple and right first): the TPU walks the candidate axis as a
// sequential grid dimension with a VMEM carry; here one warp owns one query
// and loops over its row itself (candidate_argmin.cuh), so CK needs no
// padding and the lanes read the row coalesced. 8 warps per block; no
// shared memory. Later work: read the cell start/count tables directly
// instead of the materialised gather, which is what makes this bound by
// bytes in the first place.

#include <cuda_runtime.h>

#include "candidate_argmin.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    candidate_sweep_kernel(const float* __restrict__ q,
                           const float* __restrict__ cand,
                           float* __restrict__ best_d2,
                           int* __restrict__ best_slot, long long rows,
                           int ck) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const fpps::SlotMin best =
      fpps::warp_argmin(cand + r * 3 * static_cast<long long>(ck), ck,
                        q[3 * r], q[3 * r + 1], q[3 * r + 2], lane);
  if (lane == 0) {
    best_d2[r] = best.d2;
    best_slot[r] = best.slot;
  }
}

}  // namespace

extern "C" {

int fpps_grid_warps_per_block() { return kWarpsPerBlock; }

// Launches the sweep on `stream`. Returns cudaGetLastError() after the
// launch (0 on success); never synchronises.
int fpps_candidate_sweep(const float* q, const float* cand, float* best_d2,
                         int* best_slot, long long rows, int ck,
                         void* stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rows < 1 || ck < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  candidate_sweep_kernel<<<static_cast<unsigned>(blocks),
                           kWarpsPerBlock * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, cand, best_d2, best_slot, rows, ck);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
