// Fused ICP moment pass for Hopper (sm_90a): point-to-point (18 planes) and
// point-to-plane (45 planes), with the optional bf16 prune screen.
//
// Replaces the TPU kernel src/repro/kernels/fused_icp.py::_fused_kernel
// (called through fused_moment_sweep). For transformed queries q (rows, 3),
// their mask sv (rows,) and candidate rows cand (rows, CK, 3) fp32 (masked
// slots at the 1e15 sentinel), each query:
//
//   1. finds its nearest candidate (the candidate sweep of nn_search_grid.cu,
//      lowest slot among equal d²) and takes the winner's coordinates wq,
//      and for point-to-plane the winner's normal n from cand_n (rows, CK, 3)
//      at the same slot (one 12-byte row per query; invalid slots hold 0);
//   2. recomputes d² = ||q - wq||² exactly, gates it (w = [d² <= gate²]·sv)
//      and applies the IRLS weight of the reference
//      (fused_icp.py:192-199) on the residual: r = sqrt(d²) for
//      point-to-point, |r| with r = n·(q - wq) for point-to-plane; huber
//      w·min(1, s / max(r, 1e-12)), tukey w·(1 - u²)² for
//      u = r / max(s, 1e-12) < 1;
//   3. writes its planes to planes (B, P, N) at its own column: w, then for
//      point-to-plane the 21 of w·a⊗a (upper triangle, row-major) and the 6
//      of w·r·a with a = [q×n; n], then w·p, w·wq, w·p⊗wq, w·|p|², w·|wq|²
//      (P = 18 or 45, the order of P2P_MOMENTS / P2PLANE_MOMENTS).
//
// Prune (kPrune): before the fp32 update each lane rounds its slot's fp32
// offsets (the same q - c the exact d² is built from) to bf16 and squares
// and sums them in bf16; a slot whose screen distance exceeds
// (gate · 1.1)² (kernels/ref.py::PRUNE_MARGIN) is left out of the argmin,
// and a warp skips the fp32 update of a 32-slot step that __any_sync finds
// empty. The screen is within (1 + 2^-8)^5 < 1.02 of the fp32 d², and
// 1.1² exceeds that, so a candidate within the gate is never screened:
// the winner is the same whenever its weight can be non-zero. The TPU kernel
// rounds the raw coordinates to bf16 instead, which at 30-60 m scene
// coordinates is off by up to 0.25 m per axis and screens true inliers.
//
// The wrapper sums the planes over N with torch.sum, in a fixed order, as
// the reference sums outside its kernel: no float atomics, so the result is
// the same from run to run. A row of zero weight (gate, sv, robust weight,
// or an empty neighbourhood, whose winner is slot 0 at the sentinel and
// fails the gate) writes +0 in every plane, so the planes do not depend on
// which zero-weight winner was picked: with and without prune they are the
// same bits. All arithmetic uses round-to-nearest intrinsics, so the plain
// version (kernels/ref.py::fused_moment_planes) computes the same bits.
//
// Bound on an H100 SXM: bytes, as for the sweep: the candidate matrix is
// read once (42.5 MB at B=1, N=4096, CK=864: 0.0127 ms at 3.35 TB/s); the
// winner's normal (12 B per query) and the 18 or 45 planes written (0.3 or
// 0.7 MB) are small beside it. Design: one warp per query, kWarps per block
// (2, 4, 8 or 16, the launch setting that the autotune sweep ranks; 8 by
// default); lane 0 runs the epilogue. A query's arithmetic does not depend
// on the block it lies in, so every setting gives the same bits. Later
// work: read the cell tables directly, and reduce the planes in the kernel
// in a fixed order.
//
// fpps_fused_attributes reports each instantiation's registers, local
// (spill) bytes, static shared bytes and resident blocks per SM
// (kernel_attributes.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "candidate_argmin.cuh"
#include "kernel_attributes.cuh"

namespace {

constexpr int kP2PPlanes = 18;
constexpr int kP2PlanePlanes = 45;
enum Robust { kNone = 0, kHuber = 1, kTukey = 2 };

// The bf16 screen: true where the slot may be within the gate.
__device__ __forceinline__ bool screen(float dx, float dy, float dz,
                                       float limit2) {
  const __nv_bfloat16 bx = __float2bfloat16_rn(dx);
  const __nv_bfloat16 by = __float2bfloat16_rn(dy);
  const __nv_bfloat16 bz = __float2bfloat16_rn(dz);
  const __nv_bfloat16 d2 =
      __hadd(__hadd(__hmul(bx, bx), __hmul(by, by)), __hmul(bz, bz));
  return __bfloat162float(d2) <= limit2;
}

// The candidate sweep among the slots that pass the screen. Every lane must
// call it; all lanes return the result. Screened slots never win; a row
// whose slots are all screened returns (+inf, slot 0).
__device__ __forceinline__ fpps::SlotMin screened_argmin(
    const float* __restrict__ row, int ck, float px, float py, float pz,
    int lane, float limit2) {
  fpps::SlotMin best{__int_as_float(0x7f800000), 0};
  for (int base = 0; base < ck; base += 32) {
    const int s = base + lane;
    float dx = 0.0f, dy = 0.0f, dz = 0.0f;
    bool keep = false;
    if (s < ck) {
      const float* c = row + 3 * static_cast<size_t>(s);
      dx = __fsub_rn(px, c[0]);
      dy = __fsub_rn(py, c[1]);
      dz = __fsub_rn(pz, c[2]);
      keep = screen(dx, dy, dz, limit2);
    }
    if (!__any_sync(fpps::kFullMask, keep)) continue;  // a cold step
    if (keep) {
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best.d2) {
        best.d2 = d2;
        best.slot = s;
      }
    }
  }
  return fpps::warp_min(best);
}

template <int kWarps, bool kPlane, bool kPrune>
__global__ void __launch_bounds__(kWarps * 32)
    fused_kernel(const float* __restrict__ q, const float* __restrict__ sv,
                 const float* __restrict__ cand,
                 const float* __restrict__ cand_n, float* __restrict__ planes,
                 long long rows, int n, int ck, float gate2, float limit2,
                 int robust, float scale, float tukey_c) {
  constexpr int kPlanes = kPlane ? kP2PlanePlanes : kP2PPlanes;
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long row_off = r * 3 * static_cast<long long>(ck);
  const float* row = cand + row_off;
  const float px = q[3 * r], py = q[3 * r + 1], pz = q[3 * r + 2];
  const fpps::SlotMin best =
      kPrune ? screened_argmin(row, ck, px, py, pz, lane, limit2)
             : fpps::warp_argmin(row, ck, px, py, pz, lane);
  if (lane != 0) return;

  const float* c = row + 3 * static_cast<long long>(best.slot);
  const float qx = c[0], qy = c[1], qz = c[2];
  const float ex = __fsub_rn(px, qx);
  const float ey = __fsub_rn(py, qy);
  const float ez = __fsub_rn(pz, qz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                             __fmul_rn(ez, ez));
  float w = __fmul_rn(d2 <= gate2 ? 1.0f : 0.0f, sv[r]);
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, res = 0.0f;
  if (kPlane) {
    const float* nv = cand_n + row_off + 3 * static_cast<long long>(best.slot);
    nx = nv[0];
    ny = nv[1];
    nz = nv[2];
    res = __fadd_rn(__fadd_rn(__fmul_rn(nx, ex), __fmul_rn(ny, ey)),
                    __fmul_rn(nz, ez));
  }
  if (robust != kNone) {
    const float resid = kPlane ? fabsf(res) : __fsqrt_rn(fmaxf(d2, 0.0f));
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
  if (w == 0.0f) {  // +0 in every plane, whichever winner was picked
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) out[static_cast<long long>(k) * n] = 0.0f;
    return;
  }
  int k = 0;
  out[0] = w;
  ++k;
  if (kPlane) {
    const float a[6] = {
        __fsub_rn(__fmul_rn(py, nz), __fmul_rn(pz, ny)),
        __fsub_rn(__fmul_rn(pz, nx), __fmul_rn(px, nz)),
        __fsub_rn(__fmul_rn(px, ny), __fmul_rn(py, nx)), nx, ny, nz};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wa = __fmul_rn(w, a[i]);
#pragma unroll
      for (int j = i; j < 6; ++j) {
        out[static_cast<long long>(k++) * n] = __fmul_rn(wa, a[j]);
      }
    }
    const float wr = __fmul_rn(w, res);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      out[static_cast<long long>(k++) * n] = __fmul_rn(wr, a[i]);
    }
  }
  const float p[3] = {px, py, pz};
  const float wq[3] = {qx, qy, qz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    out[static_cast<long long>(k + a) * n] = __fmul_rn(w, p[a]);
    out[static_cast<long long>(k + 3 + a) * n] = __fmul_rn(w, wq[a]);
  }
  k += 6;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float wp = __fmul_rn(w, p[a]);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[static_cast<long long>(k++) * n] = __fmul_rn(wp, wq[j]);
    }
  }
  out[static_cast<long long>(k++) * n] = __fmul_rn(
      w, __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                   __fmul_rn(pz, pz)));
  out[static_cast<long long>(k) * n] = __fmul_rn(
      w, __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                   __fmul_rn(qz, qz)));
}

// Every instantiation has this signature.
using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, long long, int, int, float,
                        float, int, float, float);

template <int kWarps>
Kernel pick(bool plane, bool prune) {
  if (plane) {
    return prune ? fused_kernel<kWarps, true, true>
                 : fused_kernel<kWarps, true, false>;
  }
  return prune ? fused_kernel<kWarps, false, true>
               : fused_kernel<kWarps, false, false>;
}

// The kernel of a launch setting, or null for a warp count not built.
Kernel select(int warps, bool plane, bool prune) {
  switch (warps) {
    case 2: return pick<2>(plane, prune);
    case 4: return pick<4>(plane, prune);
    case 8: return pick<8>(plane, prune);
    case 16: return pick<16>(plane, prune);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int fpps_fused_planes(int plane) {
  return plane ? kP2PlanePlanes : kP2PPlanes;
}

// Launches the pass on `stream` with `warps` warps (queries) per block, one
// of 2, 4, 8, 16; planes is (rows / n, P, n) with P =
// fpps_fused_planes(cand_n != nullptr). cand_n is null for point-to-point.
// prune != 0 screens at limit2 = (gate · PRUNE_MARGIN)². Returns
// cudaGetLastError() after the launch (0 on success); never synchronises.
int fpps_fused(const float* q, const float* sv, const float* cand,
               const float* cand_n, float* planes, long long rows, int n,
               int ck, float gate2, int prune, float limit2, int robust,
               float scale, float tukey_c, int warps, void* stream) {
  const Kernel kernel = select(warps, cand_n != nullptr, prune != 0);
  if (kernel == nullptr || rows < 1 || n < 1 || rows % n != 0 || ck < 1 ||
      robust < kNone || robust > kTukey) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), warps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      q, sv, cand, cand_n, planes, rows, n, ck, gate2, limit2, robust, scale,
      tukey_c);
  return static_cast<int>(cudaGetLastError());
}

// The compiled resources of the setting (warps, plane, prune) on the
// current device, into out[0..5]: fpps::kernel_attributes at warps * 32
// threads a block. Returns a cudaError_t (0 on success).
int fpps_fused_attributes(int warps, int plane, int prune, int* out) {
  const Kernel kernel = select(warps, plane != 0, prune != 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fpps::kernel_attributes(reinterpret_cast<const void*>(kernel),
                                 warps * 32, out);
}

}  // extern "C"
