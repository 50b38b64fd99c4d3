// Top-2 nearest-neighbour search over descriptor pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel sfm_danpipeline_tpu/ops/matching.py `knn2_pallas`
// (kernel body `_knn2_kernel`). For every listed pair p and every row a of
// image pair_i[p]'s descriptors, over all rows b of image pair_j[p]:
//
//   d2(a, b) = max(|a|^2 + |b|^2 - 2 a.b, 0), with invalid b set to 3.4e38
//   best     = argmin_b d2 (lowest index on ties), and its d2
//   second   = min d2 over b that is neither the best column nor within
//              sqrt(dup_r2) px of the best keypoint's xy (SIFT emits two rows
//              per position for secondary orientations; the runner-up for the
//              Lowe ratio must be a different physical point).
//
// What bounds it: at the main-path shape (P = 45 pairs, Ka = Kb = 2048,
// D = 128) the search is 2 * P * Ka * Kb * D = 48 GFLOP of fp32 FMA per pass
// over B, while the inputs are a few MB that stay in L2. Every B tile a block
// loads is reused by all TA rows of its A tile, so the kernel is bound by
// fp32 FMA issue, not by memory.
//
// Design: one block per (tile of TA = 64 A rows, pair). The block walks B in
// tiles of TB = 64 columns; 256 threads each hold a 4x4 register tile of the
// 64x64 cross products, built from 32-deep descriptor chunks staged in shared
// memory. Plain fp32 FMA, no TF32 and no tensor cores. A streaming running
// top-2 would be wrong: the excluded set depends on the FINAL best column.
// So the block makes two passes over B: pass 1 finds the argmin; pass 2
// recomputes the distances and takes the minimum over the columns that the
// best's position does not exclude. The recompute doubles the FLOPs but needs
// no shared memory proportional to Kb, so any keypoint count works.
//
// The additions in the distance and exclusion tests use __fadd_rn / __fmul_rn
// so that nvcc does not contract them into FMAs: their rounding then matches
// the plain PyTorch version's elementwise arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TA = 64;   // A rows per block
constexpr int TB = 64;   // B columns per tile
constexpr int TK = 32;   // descriptor elements per shared-memory chunk
constexpr int NT = 256;  // threads per block: 16 x 16, each a 4x4 micro-tile
constexpr int PAD = 4;   // keeps float4 rows 16-byte aligned
constexpr float kInf = 3.4e38f;

struct Smem {
  float As[TK][TA + PAD];
  float Bs[TK][TB + PAD];
  float na[TA];
  float nb[TB];
  float bx[TB];
  float by[TB];
  uint8_t vb[TB];
  int best_idx[TA];
};

// Squared norms of `n` rows starting at `row0` (4 threads per row).
__device__ void row_norms(const float* __restrict__ M, int row0, int n_rows,
                          int K, int D, float* out) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float s = 0.f;
  const int gr = row0 + r;
  if (r < n_rows && gr < K) {
    const float* row = M + (size_t)gr * D;
    for (int k = part; k < D; k += 4) s = fmaf(row[k], row[k], s);
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (r < n_rows && part == 0) out[r] = s;
}

// acc[i][j] = A[row0 + ty*4 + i] . B[col0 + tx*4 + j]
__device__ void cross_tile(Smem& sm, const float* __restrict__ A,
                           const float* __restrict__ B, int row0, int col0,
                           int K, int D, float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += TK) {
    for (int e = tid; e < TA * TK; e += NT) {
      const int r = e / TK, k = e % TK, gk = k0 + k;
      const int ga = row0 + r, gb = col0 + r;
      sm.As[k][r] = (ga < K && gk < D) ? A[(size_t)ga * D + gk] : 0.f;
      sm.Bs[k][r] = (gb < K && gk < D) ? B[(size_t)gb * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ void load_b_meta(Smem& sm, const float* __restrict__ B,
                            const uint8_t* __restrict__ vb,
                            const float* __restrict__ xyb, int col0, int K,
                            int D) {
  row_norms(B, col0, TB, K, D, sm.nb);
  const int c = threadIdx.x;
  if (c < TB) {
    const int gc = col0 + c;
    sm.vb[c] = gc < K ? vb[gc] : 0;
    sm.bx[c] = gc < K ? xyb[2 * gc] : 0.f;
    sm.by[c] = gc < K ? xyb[2 * gc + 1] : 0.f;
  }
}

__device__ __forceinline__ float dist2(float na, float nb, float cross,
                                       bool valid) {
  const float d = __fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, cross));
  return valid ? fmaxf(d, 0.f) : kInf;
}

__global__ void __launch_bounds__(NT)
knn2_kernel(const float* __restrict__ desc, const uint8_t* __restrict__ valid,
            const float* __restrict__ xy, const int* __restrict__ pair_i,
            const int* __restrict__ pair_j, int K, int D, float dup_r2,
            int* __restrict__ out_idx, float* __restrict__ out_best,
            float* __restrict__ out_second) {
  __shared__ __align__(16) Smem sm;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TA;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* A = desc + (size_t)pair_i[p] * K * D;
  const int jb = pair_j[p];
  const float* B = desc + (size_t)jb * K * D;
  const uint8_t* vb = valid + (size_t)jb * K;
  const float* xyb = xy + (size_t)jb * K * 2;

  row_norms(A, row0, TA, K, D, sm.na);

  // ---- Pass 1: argmin over B (lowest index on ties).
  float best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = __int_as_float(0x7f800000);  // +inf: above the 3.4e38 sentinel
    bidx[i] = 0x7fffffff;
  }
  float acc[4][4];
  for (int col0 = 0; col0 < K; col0 += TB) {
    __syncthreads();  // previous tile's epilogue is done with sm.nb / sm.vb
    load_b_meta(sm, B, vb, xyb, col0, K, D);
    cross_tile(sm, A, B, row0, col0, K, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx * 4 + j, c = col0 + cl;
      if (c >= K) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dist2(sm.na[ty * 4 + i], sm.nb[cl], acc[i][j],
                              sm.vb[cl] != 0);
        if (d < best[i]) {  // columns arrive in increasing order per thread
          best[i] = d;
          bidx[i] = c;
        }
      }
    }
  }
  // Reduce across the 16 threads (lanes) that share these rows.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ob < best[i] || (ob == best[i] && oi < bidx[i])) {
        best[i] = ob;
        bidx[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gr = row0 + r;
      sm.best_idx[r] = bidx[i];
      if (gr < K) {
        out_idx[(size_t)p * K + gr] = bidx[i];
        out_best[(size_t)p * K + gr] = best[i];
      }
    }
  }
  __syncthreads();

  // ---- Pass 2: second best, excluding the best column and its co-located
  // twins.
  float bxr[4], byr[4], second[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bidx[i] = sm.best_idx[ty * 4 + i];
    bxr[i] = xyb[2 * bidx[i]];
    byr[i] = xyb[2 * bidx[i] + 1];
    second[i] = kInf;
  }
  for (int col0 = 0; col0 < K; col0 += TB) {
    __syncthreads();
    load_b_meta(sm, B, vb, xyb, col0, K, D);
    cross_tile(sm, A, B, row0, col0, K, D, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx * 4 + j, c = col0 + cl;
      if (c >= K) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool excl = c == bidx[i];
        if (dup_r2 > 0.f) {
          const float dx = __fsub_rn(sm.bx[cl], bxr[i]);
          const float dy = __fsub_rn(sm.by[cl], byr[i]);
          excl = excl ||
                 __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= dup_r2;
        }
        if (!excl) {
          const float d = dist2(sm.na[ty * 4 + i], sm.nb[cl], acc[i][j],
                                sm.vb[cl] != 0);
          second[i] = fminf(second[i], d);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int off = 8; off > 0; off >>= 1)
      second[i] = fminf(second[i], __shfl_xor_sync(0xffffffffu, second[i], off));
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty * 4 + i;
      if (gr < K) out_second[(size_t)p * K + gr] = second[i];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// of contiguous tensors: desc (N, K, D) f32, valid (N, K) u8, xy (N, K, 2)
// f32, pair_i / pair_j (P,) i32, outputs (P, K). Launches on `stream` and
// returns cudaGetLastError() as an int.
extern "C" int knn2_launch(const float* desc, const uint8_t* valid,
                           const float* xy, const int* pair_i,
                           const int* pair_j, int n_pairs, int K, int D,
                           float dup_r2, int* out_idx, float* out_best,
                           float* out_second, cudaStream_t stream) {
  if (n_pairs <= 0 || K <= 0) return 0;
  const dim3 grid((K + TA - 1) / TA, n_pairs);
  knn2_kernel<<<grid, NT, 0, stream>>>(desc, valid, xy, pair_i, pair_j, K, D,
                                       dup_r2, out_idx, out_best, out_second);
  return (int)cudaGetLastError();
}
