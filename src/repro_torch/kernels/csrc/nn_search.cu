// Brute-force nearest-neighbour search for Hopper (sm_90a): FPPS's PE array.
//
// Replaces the TPU kernel src/repro/kernels/nn_search.py::_nn_kernel (called
// through nn_search_kernel). Operands src_aug (B, 8, Np) and dst_aug
// (B, 8, Mp), fp32, come from repro_torch/kernels/ref.py: source rows
// [p', 1, |p'|², 0..], target rows [-2q, |q|², 1, 0..]. Row 4 of dst_aug
// is 1 in every column, so the fifth term of a score adds the per-query
// constant |p'|² and the search runs on the four-term sum:
//
//   s4[i, j]    = sum_k src_aug[k, i] * dst_aug[k, j]          (k = 0..3)
//   best_idx[i] = the earliest j reaching min_j s4[i, j] (strict < in
//                 ascending j)
//   best_d2[i]  = s4[i, best_idx[i]] + src_aug[4, i]   (one rounding;
//                 unclamped)
//
// Adding a constant with one rounding is monotone, so best_d2 has the bits
// of the five-term min_j (s4 + |p'|²). The index differs from the five-term
// argmin only where two columns' five-term scores are exactly equal while
// their four-term sums are not; ref.blocked_argmin makes the same choice,
// so kernel and plain version give the same bits. s4 is one FMUL then three
// FFMA in ascending k, on the CUDA cores (no tensor cores, no TF32), the
// rounding of the plain version's fp32 matmul.
//
// Bound on an H100 SXM: the search needs 4 FMA per (i, j) pair (the
// four-term sum) and one add per query; at N = 4096, M = 32768, 0.54 G FMA,
// ~16 us at the 33.5 T FMA/s (67 TFLOP/s) fp32 rate; ~64 us at M = 131072
// (the five-term product of the first port counted 5 FMA a pair, ~20 and
// ~80 us). The target operand is 0.65-2.6 MB and stays in L2, so the
// kernel is bound by operations, not bytes. An FFMA issues at one warp
// instruction per clock per SM sub-partition, the issue rate itself, so
// every other instruction (compare, select, shared load, loop) takes an
// issue slot from the FMAs. The design keeps those few:
//
//  * Register-tiled queries. Each thread owns kQ = 2 source points: their
//    augmented values and their running (best, group) live in registers. A
//    target read from shared memory feeds kQ independent score chains; 256
//    threads make a block of 512 queries.
//  * Four FMA-pipe instructions a pair, not five: |p'|² is added once per
//    query at the end (above).
//  * One compare per group of kG = 8 targets, and no branch. A query scores
//    kG consecutive targets, takes their minimum with fminf (kG - 1 FMNMX,
//    on the ALU pipe beside the FMA pipe) and compares it once with best,
//    strict <; two selects keep the smaller value and the first column of
//    the group that gave it. After the sweep the winning group's kG scores
//    are computed again (from L2, the same arithmetic) and the lowest
//    column whose score equals best is the index, with that score's bits.
//    This is the one-pair-at-a-time strict-< scan's result. That scan
//    keeps the first j whose score equals the minimum (a NaN is never <,
//    and -0 == +0). A group whose minimum is not < best holds no score
//    < best, so the scan would not move there either; the first group that
//    holds the final minimum is the one that lowers best to it, and no
//    later group displaces it, since equal is not <. Inside that group the
//    first score equal to the minimum is the scan's winner. A branch taken
//    only when a group improves was slower: a group seldom improves for
//    one query, but often for some lane of a warp (short split ranges
//    restart the running minimum), and the branch's convergence barriers
//    cost issue slots on every step.
//  * Asynchronous target tiles. Each tile is four rows of up to kTileM
//    floats, structure of arrays in shared memory. Thread 0 copies each row
//    as one contiguous cp.async.bulk (the TMA's 1-D copy) that completes on
//    the stage's mbarrier; kStages stages form a ring, so the next tiles
//    arrive while the current one is swept. Four consecutive targets of a
//    row are one float4 load, the same address across the warp (a
//    broadcast).
//  * One device kernel per call. At B = 1 the 4096 queries fill only 8
//    blocks, so the target axis is also split over gridDim.y into S ranges
//    of whole groups (near-equal, so the blocks of a wave end together; the
//    last tile of a range may be short). The wrapper picks S for ~2 blocks
//    per SM and ranges of 2-16 tiles. The splits are merged inside the
//    kernel (route (b), the last block finishes the merge). Each block
//    folds its partial (s4, idx) into its queries' 64-bit merge keys with
//    an integer atomicMin (no float atomics): the key orders by s4, then by
//    index, so the minimum is what the ascending strict-< merge of the
//    splits gives, whatever order the blocks finish in, and the merge
//    costs no pass over a (B, S, Np) scratch at the end. The block then
//    takes a ticket from its query tile's counter; the one that draws
//    ticket S - 1 reads the merged keys (leaving them empty), adds |p'|²,
//    writes the result and puts the counter back to 0 for the next launch.
//    Route (a), a cluster along the split axis merging through distributed
//    shared memory, caps S at 8 (16 non-portable) blocks co-resident on one
//    GPC; register tiling makes a block cover hundreds of queries, so B = 1
//    has only a few query tiles and needs S of ~33 to fill 132 SMs.
//  * The batch goes on gridDim.z, so a frame batch is one launch.
//
// The library reports kBlockN and kTileM to its wrapper, and the kernel's
// compiled resources (fpps_nn_attributes). Its static shared memory is the
// tile ring, kStages * kRows * kTileM floats (8 KB), the kStages stage
// barriers (8 B each) and the merge flag (4 B):
// kernels/nn_search.py::smem_bytes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "kernel_attributes.cuh"

namespace {

constexpr int kAugRows = 8;             // rows of an operand; 5..7 are 0
constexpr int kRows = 4;                // rows of the sum; row 4 is |p'|²
constexpr int kQ = 2;                   // queries per thread
constexpr int kThreads = 256;           // threads per block
constexpr int kBlockN = kQ * kThreads;  // queries per block
constexpr int kG = 8;                   // targets per compare group
constexpr int kTileM = 128;             // targets per shared-memory tile
constexpr int kStages = 4;              // tiles in flight

static_assert(kG % 4 == 0 && kTileM % kG == 0, "groups are whole float4s");
static_assert(kG * sizeof(float) % 16 == 0, "bulk copies are 16 B units");
static_assert(kThreads % 32 == 0, "whole warps");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous global -> shared copy by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The merge key of a split's partial (s4, j): s4's bits mapped so that
// unsigned order is float order (s4 + 0 first, so -0 and +0 are one
// value), then j. The smallest key is the smallest s4 and, among equal
// ones, the first index: the ascending strict-< merge of the splits.
constexpr unsigned long long kEmptyKey = ~0ull;  // above every key

__device__ __forceinline__ unsigned long long merge_key(float s4, int j) {
  const unsigned u = __float_as_uint(__fadd_rn(s4, 0.0f));
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ordered) << 32) |
         static_cast<unsigned>(j);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ordered = static_cast<unsigned>(key >> 32);
  return __uint_as_float((ordered & 0x80000000u) ? (ordered ^ 0x80000000u)
                                                 : ~ordered);
}

// s4[i, j] of query slot q and group column e: one FMUL then three FFMA in
// ascending k, the fp32 matmul's rounding.
__device__ __forceinline__ float score(const float (&p)[kRows][kQ], int q,
                                       const float (&x)[kRows][kG], int e) {
  float v = p[0][q] * x[0][e];
  v = fmaf(p[1][q], x[1][e], v);
  v = fmaf(p[2][q], x[2][e], v);
  return fmaf(p[3][q], x[3][e], v);
}

__global__ void __launch_bounds__(kThreads)
    nn_search_kernel(const float* __restrict__ src_aug,
                     const float* __restrict__ dst_aug,
                     unsigned long long* __restrict__ acc,
                     unsigned* __restrict__ tickets,
                     float* __restrict__ best_d2, int* __restrict__ best_idx,
                     int np, int mp, int n_splits) {
  __shared__ __align__(128) float tile[kStages][kRows][kTileM];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int merge_here;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const float* s = src_aug + static_cast<size_t>(b) * kAugRows * np;
  const float* d = dst_aug + static_cast<size_t>(b) * kAugRows * mp;
  const int i0 = qt * kBlockN + tid;  // query q of this thread: i0 + q*kThreads

  // This block's range of target columns: split `split` of S near-equal
  // runs of whole groups, cut into tiles of up to kTileM columns.
  const int n_groups = mp / kG;
  const int c_begin = static_cast<int>(
      static_cast<long long>(split) * n_groups / n_splits) * kG;
  const int c_end = static_cast<int>(
      static_cast<long long>(split + 1) * n_groups / n_splits) * kG;
  const int n_local = (c_end - c_begin + kTileM - 1) / kTileM;  // >= 1

  auto issue = [&](int k) {  // thread 0: tile k of the range into its stage
    const int st = k % kStages;
    const int col = c_begin + k * kTileM;
    const unsigned bytes = min(kTileM, c_end - col) * sizeof(float);
    mbar_expect_tx(&full[st], kRows * bytes);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      bulk_copy(&tile[st][r][0], d + static_cast<size_t>(r) * mp + col, bytes,
                &full[st]);
    }
  };

  if (tid == 0) {  // the first tiles are in flight before the CTA barrier
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kStages && k < n_local; ++k) issue(k);
  }

  float p[kRows][kQ];
  float norm2[kQ];  // row 4: |p'|², added once to the winner
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r][q] = s[static_cast<size_t>(r) * np + i0 + q * kThreads];
    }
    norm2[q] = s[static_cast<size_t>(kRows) * np + i0 + q * kThreads];
  }
  __syncthreads();  // the barriers are initialised before anyone waits
  float best[kQ];
  int best_c[kQ];  // first column of the first group that reached best
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    best[q] = __int_as_float(0x7f800000);  // +inf
    best_c[q] = -1;
  }

  for (int k = 0; k < n_local; ++k) {
    const int st = k % kStages;
    mbar_wait(&full[st], (k / kStages) & 1);
    const int j_tile = c_begin + k * kTileM;
    const int cols = min(kTileM, c_end - j_tile);  // a multiple of kG
#pragma unroll 2
    for (int c = 0; c < cols; c += kG) {
      float x[kRows][kG];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int g = 0; g < kG; g += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&tile[st][r][c + g]);
          x[r][g] = v.x;
          x[r][g + 1] = v.y;
          x[r][g + 2] = v.z;
          x[r][g + 3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float m[kG];
#pragma unroll
        for (int e = 0; e < kG; ++e) m[e] = score(p, q, x, e);
#pragma unroll
        for (int w = kG / 2; w > 0; w /= 2) {
#pragma unroll
          for (int e = 0; e < w; ++e) m[e] = fminf(m[e], m[e + w]);
        }
        const bool better = m[0] < best[q];  // strict: ties keep the first
        best[q] = better ? m[0] : best[q];
        best_c[q] = better ? j_tile + c : best_c[q];
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (tid == 0 && k + kStages < n_local) issue(k + kStages);
  }

  // The first target of the winning group that reaches its minimum: its
  // kG scores again, from L2, with the same arithmetic, scanned downwards
  // so that the lowest equal index is the one kept, with its own bits.
  int best_j[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    best_j[q] = 0;
    if (best_c[q] < 0) continue;  // no score beat +inf (all NaN)
    float x[kRows][kG];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int g = 0; g < kG; g += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            d + static_cast<size_t>(r) * mp + best_c[q] + g));
        x[r][g] = v.x;
        x[r][g + 1] = v.y;
        x[r][g + 2] = v.z;
        x[r][g + 3] = v.w;
      }
    }
#pragma unroll
    for (int e = kG - 1; e >= 0; --e) {
      const float v = score(p, q, x, e);
      if (v == best[q]) {
        best[q] = v;
        best_j[q] = best_c[q] + e;
      }
    }
  }

  if (n_splits == 1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t o = static_cast<size_t>(b) * np + i0 + q * kThreads;
      best_d2[o] = __fadd_rn(best[q], norm2[q]);
      best_idx[o] = best_j[q];
    }
    return;
  }
  unsigned long long* keys = acc + static_cast<size_t>(b) * np + i0;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    atomicMin(keys + q * kThreads, merge_key(best[q], best_j[q]));
  }
  // The ticket protocol of a grid-wide barrier: the CTA barrier orders the
  // block's atomics before thread 0's ticket, an acquire-release atomic at
  // GPU scope, so the block drawing the last ticket sees every block's
  // keys once its own CTA barrier has passed.
  __syncthreads();
  unsigned* ticket = tickets + static_cast<size_t>(b) * gridDim.x + qt;
  if (tid == 0) {
    unsigned t;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(ticket)
                 : "memory");
    merge_here = t == static_cast<unsigned>(n_splits - 1);
  }
  __syncthreads();
  if (!merge_here) return;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {  // read the merged key, leave it empty
    const unsigned long long key = atomicExch(keys + q * kThreads, kEmptyKey);
    const size_t o = static_cast<size_t>(b) * np + i0 + q * kThreads;
    best_d2[o] = __fadd_rn(key_value(key), norm2[q]);
    best_idx[o] = static_cast<int>(key & 0xffffffffu);
  }
  if (tid == 0) *ticket = 0;  // left at zero for the next launch
}

}  // namespace

extern "C" {

int fpps_nn_block_n() { return kBlockN; }
int fpps_nn_tile_m() { return kTileM; }

// Launches the search on `stream`: one kernel. acc holds batch * np merge
// keys that are all ones and are left so, tickets batch * (np / kBlockN)
// counters that are zero and are left at zero; both are unused when
// n_splits == 1. dst_aug must be 16-byte aligned (bulk copies). Returns
// cudaGetLastError() after the launch (0 on success); never synchronises.
int fpps_nn_search(const float* src_aug, const float* dst_aug, void* acc,
                   unsigned* tickets, float* best_d2, int* best_idx, int batch,
                   int np, int mp, int n_splits, void* stream) {
  if (batch < 1 || batch > 65535 || np < kBlockN || np % kBlockN != 0 ||
      mp < kTileM || mp % kTileM != 0 || n_splits < 1 ||
      n_splits > mp / kTileM || n_splits > 65535 ||
      reinterpret_cast<uintptr_t>(dst_aug) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(np / kBlockN, n_splits, batch);
  nn_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_aug, dst_aug, static_cast<unsigned long long*>(acc), tickets,
      best_d2, best_idx, np, mp, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's compiled resources on the current device, into out[0..5]:
// fpps::kernel_attributes at kThreads threads a block. Returns a
// cudaError_t (0 on success).
int fpps_nn_attributes(int* out) {
  return fpps::kernel_attributes(
      reinterpret_cast<const void*>(nn_search_kernel), kThreads, out);
}

}  // extern "C"
