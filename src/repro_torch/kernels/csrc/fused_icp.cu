// Fused point-to-point ICP moment pass for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_icp.py::_fused_kernel
// (called through fused_moment_sweep), point-to-point moment set. For
// transformed queries q (rows, 3), their mask sv (rows,) and candidate rows
// cand (rows, CK, 3) fp32 (masked slots at the 1e15 sentinel), each query:
//
//   1. finds its nearest candidate (the candidate sweep of nn_search_grid.cu,
//      lowest slot among equal d²) and takes the winner's coordinates wq;
//   2. recomputes d² = ||q - wq||² exactly, gates it (w = [d² <= gate²]·sv)
//      and applies the IRLS weight of the reference
//      (fused_icp.py:192-199): huber w·min(1, s / max(r, 1e-12)), tukey
//      w·(1 - u²)² for u = r / max(s, 1e-12) < 1, r = sqrt(d²);
//   3. writes the 18 moment planes of P2P_MOMENTS (w, w·p, w·q, w·p⊗q,
//      w·|p|², w·|q|²) to planes (B, 18, N) at its own column.
//
// The wrapper sums the planes over N with torch.sum, in a fixed order, as
// the reference sums outside its kernel: no float atomics, so the result is
// the same from run to run. A query whose neighbourhood is empty sees only
// sentinel slots: its winner is slot 0 at the sentinel (the reference's
// initial carry), d² ~ 3e30 fails the gate, w = 0 and every plane is
// exactly 0 (0 times a finite value). All arithmetic uses round-to-nearest
// intrinsics, so the plain version (kernels/ref.py::fused_moment_planes)
// computes the same bits.
//
// Bound on an H100 SXM: bytes, as for the sweep: the candidate matrix is
// read once (42.5 MB at B=1, N=4096, CK=864: 0.0127 ms at 3.35 TB/s), and
// the 18 planes written (0.3 MB) are small beside it. Design: one warp per
// query, 8 per block; lane 0 runs the epilogue. Later work: read the cell
// tables directly, reduce the planes in the kernel in a fixed order, and
// the point-to-plane moment set.

#include <cuda_runtime.h>

#include "candidate_argmin.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPlanes = 18;
enum Robust { kNone = 0, kHuber = 1, kTukey = 2 };

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fused_p2p_kernel(const float* __restrict__ q, const float* __restrict__ sv,
                     const float* __restrict__ cand,
                     float* __restrict__ planes, long long rows, int n, int ck,
                     float gate2, int robust, float scale, float tukey_c) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float* row = cand + r * 3 * static_cast<long long>(ck);
  const float px = q[3 * r], py = q[3 * r + 1], pz = q[3 * r + 2];
  const fpps::SlotMin best = fpps::warp_argmin(row, ck, px, py, pz, lane);
  if (lane != 0) return;

  const float* c = row + 3 * static_cast<long long>(best.slot);
  const float qx = c[0], qy = c[1], qz = c[2];
  const float ex = __fsub_rn(px, qx);
  const float ey = __fsub_rn(py, qy);
  const float ez = __fsub_rn(pz, qz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                             __fmul_rn(ez, ez));
  float w = __fmul_rn(d2 <= gate2 ? 1.0f : 0.0f, sv[r]);
  if (robust != kNone) {
    const float resid = __fsqrt_rn(fmaxf(d2, 0.0f));
    if (robust == kHuber) {
      w = __fmul_rn(w, fminf(__fdiv_rn(scale, fmaxf(resid, 1e-12f)), 1.0f));
    } else {
      const float u = __fdiv_rn(resid, tukey_c);
      const float t = __fsub_rn(1.0f, __fmul_rn(u, u));
      w = __fmul_rn(w, u < 1.0f ? __fmul_rn(t, t) : 0.0f);
    }
  }

  const long long b = r / n;
  float* out = planes + b * kPlanes * n + (r - b * n);
  const float p[3] = {px, py, pz};
  const float wq[3] = {qx, qy, qz};
  out[0] = w;
  for (int a = 0; a < 3; ++a) {
    out[static_cast<long long>(1 + a) * n] = __fmul_rn(w, p[a]);
    out[static_cast<long long>(4 + a) * n] = __fmul_rn(w, wq[a]);
  }
  for (int a = 0; a < 3; ++a) {
    const float wp = __fmul_rn(w, p[a]);
    for (int k = 0; k < 3; ++k) {
      out[static_cast<long long>(7 + 3 * a + k) * n] = __fmul_rn(wp, wq[k]);
    }
  }
  out[16LL * n] = __fmul_rn(
      w, __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                   __fmul_rn(pz, pz)));
  out[17LL * n] = __fmul_rn(
      w, __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz)));
}

}  // namespace

extern "C" {

int fpps_fused_planes() { return kPlanes; }

// Launches the pass on `stream`; planes is (rows / n, 18, n). Returns
// cudaGetLastError() after the launch (0 on success); never synchronises.
int fpps_fused_p2p(const float* q, const float* sv, const float* cand,
                   float* planes, long long rows, int n, int ck, float gate2,
                   int robust, float scale, float tukey_c, void* stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (rows < 1 || n < 1 || rows % n != 0 || ck < 1 || robust < kNone ||
      robust > kTukey || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_p2p_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      q, sv, cand, planes, rows, n, ck, gate2, robust, scale, tukey_c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
