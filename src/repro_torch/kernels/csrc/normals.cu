// Radius-gated neighbourhood moment sweep for normal estimation, Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/normals.py::_moment_sweep_kernel
// (called through moment_sweep_kernel). Same contract: for queries
// q (rows, 3) and their candidate rows cand (rows, CK, 3), fp32, with masked
// slots already at the 1e15 sentinel (core/nn_search_grid.py),
//
//   d = cand[r, s] - q[r],   w = [d·d <= radius²]
//   out[r] = (Σw, Σw·dx, Σw·dy, Σw·dz, Σw·dx², Σw·dy², Σw·dz²,
//             Σw·dx·dy, Σw·dx·dz, Σw·dy·dz)              (rows, 10) fp32
//
// Sentinel slots sit ~1e15 m away and fail the gate, so no mask is read.
// rows is the whole batch (B * N): one launch serves a frame batch.
//
// Bound on an H100 SXM: bytes. Every candidate byte is read once for ~28
// flops (3 sub, 3 mul, 2 add, 1 compare, 9 mul and 10 add on a hit); at the
// seq-0 target (31,032 queries, CK = 27 * 32 = 864) the matrix is 322 MB:
// 0.096 ms at 3.35 TB/s, against ~0.011 ms of fp32 arithmetic at 67 TFLOP/s.
// Unlike the 42.5 MB matrix of the fused pass it does not fit the 50 MB L2.
//
// Design (simple and right first): one warp per query, as in
// nn_search_grid.cu. Lane l visits slots l, l + 32, ... in ascending order
// (coalesced 384-byte reads per step) and keeps ten running sums in
// registers, adding a slot's terms only when it passes the gate; the 32 lane
// sums are then combined by a butterfly (__shfl_xor_sync, offsets 16, 8, 4,
// 2, 1). The order is fixed, so two runs give the same bits, and every
// operation is a round-to-nearest intrinsic (no FMA contraction): the plain
// version (kernels/ref.py::normal_moments) adds in the same order and gives
// the same bits. Skipping a slot outside the gate equals adding its zero
// terms: a sum that starts at +0 never becomes -0. 8 warps per block; no
// shared memory. Later work: read the cell start/count tables directly
// instead of the materialised gather.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMoments = 10;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    moment_sweep_kernel(const float* __restrict__ q,
                        const float* __restrict__ cand,
                        float* __restrict__ out, long long rows, int ck,
                        float r2) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float* row = cand + r * 3 * static_cast<long long>(ck);
  const float qx = q[3 * r], qy = q[3 * r + 1], qz = q[3 * r + 2];
  float acc[kMoments];
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.0f;
  for (int s = lane; s < ck; s += 32) {
    const float* c = row + 3 * static_cast<size_t>(s);
    const float dx = __fsub_rn(c[0], qx);
    const float dy = __fsub_rn(c[1], qy);
    const float dz = __fsub_rn(c[2], qz);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (d2 <= r2) {
      acc[0] = __fadd_rn(acc[0], 1.0f);
      acc[1] = __fadd_rn(acc[1], dx);
      acc[2] = __fadd_rn(acc[2], dy);
      acc[3] = __fadd_rn(acc[3], dz);
      acc[4] = __fadd_rn(acc[4], __fmul_rn(dx, dx));
      acc[5] = __fadd_rn(acc[5], __fmul_rn(dy, dy));
      acc[6] = __fadd_rn(acc[6], __fmul_rn(dz, dz));
      acc[7] = __fadd_rn(acc[7], __fmul_rn(dx, dy));
      acc[8] = __fadd_rn(acc[8], __fmul_rn(dx, dz));
      acc[9] = __fadd_rn(acc[9], __fmul_rn(dy, dz));
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFullMask, acc[k], offset));
    }
  }
  if (lane == 0) {
    float* o = out + r * kMoments;
#pragma unroll
    for (int k = 0; k < kMoments; ++k) o[k] = acc[k];
  }
}

}  // namespace

extern "C" {

int fpps_normal_moments() { return kMoments; }

// Launches the sweep on `stream`; out is (rows, 10). Returns
// cudaGetLastError() after the launch (0 on success); never synchronises.
int fpps_moment_sweep(const float* q, const float* cand, float* out,
                      long long rows, int ck, float r2, void* stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rows < 1 || ck < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moment_sweep_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                        0, static_cast<cudaStream_t>(stream)>>>(
      q, cand, out, rows, ck, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
