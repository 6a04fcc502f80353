// Brute-force nearest-neighbour search for Hopper (sm_90a): FPPS's PE array.
//
// Replaces the TPU kernel src/repro/kernels/nn_search.py::_nn_kernel (called
// through nn_search_kernel). Same contract: for augmented operands
// src_aug (B, 8, Np) and dst_aug (B, 8, Mp), fp32, built by
// repro_torch/kernels/ref.py,
//
//   score[i, j] = sum_k src_aug[k, i] * dst_aug[k, j]      (k = 0..4; 5..7 = 0)
//   best_d2[i]  = min_j score[i, j]   (unclamped)
//   best_idx[i] = the earliest j reaching it (strict < in ascending j)
//
// The score is computed in full fp32 FMAs on the CUDA cores (no tensor cores,
// no TF32): one FMUL then four FFMA, in ascending k.
//
// Bound on an H100 SXM: ~5 FMA + a compare/select per (i, j) pair. At
// N = 4096, M = 32768 that is 0.67 G FMA, ~20 us at the 33.5 T FMA/s (67
// TFLOP/s) fp32 rate; ~80 us at M = 131072. The target operand is only
// 5 * M * 4 B = 0.65-2.6 MB and stays in L2, so the kernel is bound by
// operations on the CUDA cores, not by bytes.
//
// Design (simple and right first):
//  * one thread per source point, its five augmented values in registers;
//  * each block stages a target tile of 5 x kTileM floats in shared memory
//    (rows 0..3 as float4, row 4 as float: 20 KB) and sweeps it; every thread
//    reads the same address, so shared loads are broadcasts;
//  * the TPU walks target tiles in order on one core. Here 132 SMs run blocks
//    in no order, and at B = 1, N = 4096 a grid over queries alone is only 32
//    blocks. So M is also split over gridDim.y into S ranges of whole tiles;
//    each range writes a partial (d2, idx) to scratch (B, S, Np), and a
//    second kernel merges the S partials in ascending range order with strict
//    <. Ties therefore stay bit-exact first-index, with no float atomics;
//  * the batch goes on gridDim.z, so a frame batch is one launch.
// Later work: the direct-difference form, several queries per thread, a
// persistent grid.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kAugRows = 8;
constexpr int kBlockN = 128;  // threads per block = queries per block
constexpr int kTileM = 1024;  // target columns per shared-memory tile
constexpr int kMergeThreads = 256;

__device__ __forceinline__ void consider(float p0, float p1, float p2,
                                         float p3, float p4, float4 q,
                                         float q4, int j, float& best,
                                         int& best_j) {
  float s = p0 * q.x;
  s = fmaf(p1, q.y, s);
  s = fmaf(p2, q.z, s);
  s = fmaf(p3, q.w, s);
  s = fmaf(p4, q4, s);
  if (s < best) {
    best = s;
    best_j = j;
  }
}

__global__ void __launch_bounds__(kBlockN)
    nn_partial_kernel(const float* __restrict__ src_aug,
                      const float* __restrict__ dst_aug,
                      float* __restrict__ part_d2, int* __restrict__ part_idx,
                      int np, int mp, int n_splits) {
  __shared__ float4 tile_a[kTileM];            // rows 0..3
  __shared__ __align__(16) float tile_b[kTileM];  // row 4

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int i = blockIdx.x * kBlockN + threadIdx.x;  // np % kBlockN == 0
  const float* s = src_aug + static_cast<size_t>(b) * kAugRows * np;
  const float* d = dst_aug + static_cast<size_t>(b) * kAugRows * mp;
  const float p0 = s[i];
  const float p1 = s[np + i];
  const float p2 = s[2 * static_cast<size_t>(np) + i];
  const float p3 = s[3 * static_cast<size_t>(np) + i];
  const float p4 = s[4 * static_cast<size_t>(np) + i];

  const int n_tiles = mp / kTileM;
  const int t_begin = static_cast<int>(
      static_cast<long long>(split) * n_tiles / n_splits);
  const int t_end = static_cast<int>(
      static_cast<long long>(split + 1) * n_tiles / n_splits);

  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const size_t base = static_cast<size_t>(t) * kTileM;
    __syncthreads();  // every thread is done with the previous tile
    for (int c = threadIdx.x; c < kTileM; c += kBlockN) {
      tile_a[c] = make_float4(d[base + c], d[mp + base + c],
                              d[2 * static_cast<size_t>(mp) + base + c],
                              d[3 * static_cast<size_t>(mp) + base + c]);
      tile_b[c] = d[4 * static_cast<size_t>(mp) + base + c];
    }
    __syncthreads();
    const int j0 = static_cast<int>(base);
    for (int c = 0; c < kTileM; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(&tile_b[c]);
      consider(p0, p1, p2, p3, p4, tile_a[c], w.x, j0 + c, best, best_j);
      consider(p0, p1, p2, p3, p4, tile_a[c + 1], w.y, j0 + c + 1, best,
               best_j);
      consider(p0, p1, p2, p3, p4, tile_a[c + 2], w.z, j0 + c + 2, best,
               best_j);
      consider(p0, p1, p2, p3, p4, tile_a[c + 3], w.w, j0 + c + 3, best,
               best_j);
    }
  }
  const size_t o = (static_cast<size_t>(b) * n_splits + split) * np + i;
  part_d2[o] = best;
  part_idx[o] = best_j;
}

__global__ void nn_merge_kernel(const float* __restrict__ part_d2,
                                const int* __restrict__ part_idx,
                                float* __restrict__ best_d2,
                                int* __restrict__ best_idx, int np,
                                int n_splits, long long total) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= total) return;
  const long long b = g / np;
  const long long i = g - b * np;
  float best = __int_as_float(0x7f800000);
  int best_j = 0;
  for (int s = 0; s < n_splits; ++s) {  // ascending ranges, strict <
    const size_t o = (static_cast<size_t>(b) * n_splits + s) * np + i;
    const float v = part_d2[o];
    if (v < best) {
      best = v;
      best_j = part_idx[o];
    }
  }
  best_d2[g] = best;
  best_idx[g] = best_j;
}

}  // namespace

extern "C" {

int fpps_nn_block_n() { return kBlockN; }
int fpps_nn_tile_m() { return kTileM; }

// Launches the search on `stream`. part_d2/part_idx hold (batch, n_splits,
// np) scratch and are unused when n_splits == 1. Returns cudaGetLastError()
// after the launches (0 on success); never synchronises.
int fpps_nn_search(const float* src_aug, const float* dst_aug, float* part_d2,
                   int* part_idx, float* best_d2, int* best_idx, int batch,
                   int np, int mp, int n_splits, void* stream) {
  if (batch < 1 || batch > 65535 || np < kBlockN || np % kBlockN != 0 ||
      mp < kTileM || mp % kTileM != 0 || n_splits < 1 ||
      n_splits > mp / kTileM || n_splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = n_splits == 1;
  dim3 grid(np / kBlockN, n_splits, batch);
  nn_partial_kernel<<<grid, kBlockN, 0, st>>>(
      src_aug, dst_aug, direct ? best_d2 : part_d2,
      direct ? best_idx : part_idx, np, mp, n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * np;
  const unsigned blocks =
      static_cast<unsigned>((total + kMergeThreads - 1) / kMergeThreads);
  nn_merge_kernel<<<blocks, kMergeThreads, 0, st>>>(
      part_d2, part_idx, best_d2, best_idx, np, n_splits, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
