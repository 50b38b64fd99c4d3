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
// What bounds it: operations. At the main-path shape (P = 45 pairs,
// Ka = Kb = 2048, D = 128) the cross products are 2 * P * Ka * Kb * D =
// 48.3 GFLOP of fp32 multiply-add, against 12 MB of inputs and outputs that
// stay in L2. The product is plain fp32 FMA (no TF32, no tensor cores: the
// distances are held to rtol 1e-5), so the least time is the FLOPs over the
// card's fp32 rate outside the tensor cores. What the design does about it:
// every cross product is computed exactly once, and the FMA pipe is fed from
// shared memory at 16 LDS.128 per 256 FMAs. What still holds it at about half
// of that bound: with an 8 x 8 register tile a thread loads 16 floats from
// shared memory for every 64 FMAs, which at 128 B/clock of shared-memory
// delivery and 128 FMA/clock per SM keeps both pipes equally busy, so neither
// runs at its peak; a taller tile spills (12 rows per thread: 255 registers
// and a stack frame, a third slower). A launch whose block count is not a
// multiple of the 132 SMs also pays for its last, partly filled wave.
//
// Design.
//  * knn2_norms_kernel (prologue): |row|^2 of every descriptor row once, in
//    two arrays: plain (for the A side) and with 3.4e38 folded in for invalid
//    rows (for the B side).
//  * knn2_kernel<RM>: one block of 256 threads per (pair, tile of TA = 16*RM
//    A rows). The A tile is copied once into dynamic shared memory and stays
//    there. B streams through a ring of NS = 2 stages, each TB = 128 columns
//    by TK = 64 descriptor elements, filled with cp.async (16 bytes a thread)
//    so that the loads of the next stage overlap the FMAs of the current one;
//    one __syncthreads per stage (deeper rings and shorter stages measured
//    no faster, and this one leaves room for a 128-row A tile at D = 256).
//    Thread (ty, tx) holds an RM x 8 register tile: rows ty*RM + i, columns tx + 16*j. Rows are padded by 4 floats so
//    that the eight float4 B reads of a quarter-warp hit distinct banks; A
//    reads are broadcasts. RM = 8 (128 rows, one block per SM) while the A
//    tile fits beside the ring, else 4 or 2 (D = 512 takes RM = 4).
//  * One pass over B, exact. A streaming top-2 is wrong under the
//    co-location exclusion (the excluded set depends on the FINAL best), so
//    every thread keeps, per row, the CAND smallest (d2, column) it has seen
//    among its own columns, in column order with strict "<", which is
//    argmin's lowest-index tie-break. At the end the 16 threads of a row
//    merge: best = the lexicographic minimum; T = the smallest of the
//    threads' last list entries, so every column that is on no list has
//    d2 >= T; second = the smallest listed candidate that the best does not
//    exclude. That is exact whenever second <= T. Rows where it is not (the
//    best and enough of its co-located twins fell to one thread) are
//    appended to a list.
//  * knn2_flagged_kernel: finishes the listed rows exactly by a masked
//    minimum over all of B. Only flagged rows pay for it.
//
// The additions in the distance and exclusion tests use __fadd_rn / __fmul_rn
// so that nvcc does not contract them into FMAs: their rounding then matches
// the plain PyTorch version's elementwise arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block: 16 (ty) x 16 (tx)
constexpr int TB = 128;      // B columns per tile
constexpr int TK = 64;      // descriptor elements per ring stage
constexpr int SB = TK + 4;   // padded row stride of a stage, in floats
constexpr int NS = 2;       // ring stages
constexpr int CN = TB / 16;  // columns per thread
constexpr int CAND = 2;     // candidates kept per thread and row
constexpr float kInf = 3.4e38f;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dist2(float na, float nb, float cross) {
  const float d = __fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, cross));
  return nb >= kInf ? kInf : fmaxf(d, 0.f);
}

__device__ __forceinline__ bool colocated(float x, float y, float bx, float by,
                                          float dup_r2) {
  const float dx = __fsub_rn(x, bx), dy = __fsub_rn(y, by);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= dup_r2;
}

// One warp per descriptor row: nrm = |row|^2, nbm = valid ? |row|^2 : 3.4e38.
// Also resets the flagged-row counter for the launch that follows.
__global__ void __launch_bounds__(NT)
knn2_norms_kernel(const float* __restrict__ desc,
                  const uint8_t* __restrict__ valid, long long n_rows, int D,
                  float* __restrict__ nrm, float* __restrict__ nbm,
                  int* __restrict__ flag_count) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *flag_count = 0;
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const float* p = desc + row * D;
  float s = 0.f;
  for (int k = lane * 4; k < D; k += 128) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    nrm[row] = s;
    nbm[row] = valid[row] ? s : kInf;
  }
}

// Sorted insert of (d, c) into a thread's list; strict "<" keeps the earlier
// (lower) column ahead on ties, since a thread meets its columns in order.
__device__ __forceinline__ void insert(float (&ld)[CAND], int (&li)[CAND],
                                       float d, int c) {
#pragma unroll
  for (int m = CAND - 1; m >= 0; --m) {
    const bool lt = d < ld[m];
    if (m + 1 < CAND) {
      ld[m + 1] = lt ? ld[m] : ld[m + 1];
      li[m + 1] = lt ? li[m] : li[m + 1];
    }
    ld[m] = lt ? d : ld[m];
    li[m] = lt ? c : li[m];
  }
}

template <int RM>
__global__ void __launch_bounds__(NT, 1)
knn2_kernel(const float* __restrict__ desc, const float* __restrict__ xy,
            const float* __restrict__ nrm, const float* __restrict__ nbm,
            const int* __restrict__ pair_i, const int* __restrict__ pair_j,
            int K, int D, int Dp, int n_tiles_a, float dup_r2,
            int* __restrict__ out_idx, float* __restrict__ out_best,
            float* __restrict__ out_second, int* __restrict__ flag_count,
            int* __restrict__ flag_list) {
  constexpr int TA = 16 * RM;
  extern __shared__ __align__(16) float smem[];
  const int SA = Dp + 4;  // padded row stride of the A tile
  float* As = smem;
  float* Bs = smem + TA * SA;

  const int p = blockIdx.x / n_tiles_a;
  const int row0 = (blockIdx.x % n_tiles_a) * TA;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ia = pair_i[p], jb = pair_j[p];
  const float* A = desc + (size_t)ia * K * D;
  const float* B = desc + (size_t)jb * K * D;
  const float* nbB = nbm + (size_t)jb * K;
  const float* xyb = xy + (size_t)jb * K * 2;

  const int NC = Dp / TK;                      // stages per B tile
  const int total = ((K + TB - 1) / TB) * NC;  // stages in all

  auto load_stage = [&](int s) {
    const int col0 = (s / NC) * TB, k0 = (s % NC) * TK;
    float* dst = Bs + (s % NS) * (TB * SB);
#pragma unroll
    for (int q = 0; q < TB * (TK / 4) / NT; ++q) {
      const int e = tid + q * NT, r = e / (TK / 4), c4 = e % (TK / 4);
      const int col = col0 + r, k = k0 + c4 * 4;
      const bool ok = col < K && k < D;
      cp_async16(dst + r * SB + c4 * 4, ok ? B + (size_t)col * D + k : B, ok);
    }
  };

  // Group 0: the resident A tile and B stage 0; then stages 1 .. NS-2.
  {
    const int per_row = Dp / 4;
    for (int e = tid; e < TA * per_row; e += NT) {
      const int r = e / per_row, c4 = e % per_row;
      const int row = row0 + r, k = c4 * 4;
      const bool ok = row < K && k < D;
      cp_async16(As + r * SA + k, ok ? A + (size_t)row * D + k : A, ok);
    }
  }
  load_stage(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < NS - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }

  float na[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty * RM + i;
    na[i] = row < K ? nrm[(size_t)ia * K + row] : 0.f;
  }
  float ld[RM][CAND];
  int li[RM][CAND];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int m = 0; m < CAND; ++m) {
      ld[i][m] = __int_as_float(0x7f800000);  // +inf: above the 3.4e38 sentinel
      li[i][m] = 0x7fffffff;
    }

  float acc[RM][CN];
  float nbv[CN];
  int s = 0;
  for (int col0 = 0; col0 < K; col0 += TB) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < NC; ++kc, ++s) {
      cp_async_wait<NS - 2>();  // stage s has landed (for this thread)
      __syncthreads();          // ... for all; and stage s-1 is consumed
      if (s + NS - 1 < total) load_stage(s + NS - 1);
      cp_async_commit();
      if (kc == NC - 1) {  // in flight during the tile's last FMAs
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int c = col0 + tx + 16 * j;
          nbv[j] = c < K ? nbB[c] : kInf;
        }
      }
      const float* as = As + (ty * RM) * SA + kc * TK;
      const float* bs = Bs + (s % NS) * (TB * SB) + tx * SB;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 4) {
        float4 a[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          a[i] = *reinterpret_cast<const float4*>(as + i * SA + kk);
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(bs + j * 16 * SB + kk);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
          }
        }
      }
    }
    // The tile's distances go into the per-thread candidate lists.
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < K) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
          insert(ld[i], li[i], dist2(na[i], nbv[j], acc[i][j]), c);
      }
    }
  }

  // Merge across the 16 threads (half a warp) that share each row.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float bd = ld[i][0];
    int bi = li[i][0];
    float T = ld[i][CAND - 1];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
      T = fminf(T, __shfl_xor_sync(0xffffffffu, T, off));
    }
    const float bx = xyb[2 * (size_t)bi], by = xyb[2 * (size_t)bi + 1];
    float sec = kInf;
#pragma unroll
    for (int m = 0; m < CAND; ++m) {
      const int c = li[i][m];
      if (c >= K || c == bi) continue;
      if (dup_r2 > 0.f &&
          colocated(xyb[2 * (size_t)c], xyb[2 * (size_t)c + 1], bx, by, dup_r2))
        continue;
      sec = fminf(sec, ld[i][m]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sec = fminf(sec, __shfl_xor_sync(0xffffffffu, sec, off));
    const int row = row0 + ty * RM + i;
    if (tx == 0 && row < K) {
      const size_t o = (size_t)p * K + row;
      out_idx[o] = bi;
      out_best[o] = bd;
      out_second[o] = sec;
      // A column on no list has d2 >= T: `sec` is exact unless it is larger.
      if (sec > T) flag_list[atomicAdd(flag_count, 1)] = (int)o;
    }
  }
}

// Exact second-best for the flagged rows: a masked minimum over all of B.
// A work item is (flagged row, chunk of FC columns), so that a handful of
// rows still spreads over the whole card. A warp takes four columns at a
// time, eight lanes to a column, each lane striding the descriptor with
// 16-byte loads; the partial sums meet by shuffles. The row's `second`
// already holds the smallest listed candidate, an upper bound: atomicMin
// (distances are >= 0, so their bits order like ints) lowers it to the exact
// minimum.
constexpr int FC = 64;

__global__ void __launch_bounds__(NT)
knn2_flagged_kernel(const float* __restrict__ desc, const float* __restrict__ xy,
                    const float* __restrict__ nrm, const float* __restrict__ nbm,
                    const int* __restrict__ pair_i,
                    const int* __restrict__ pair_j, int K, int D, float dup_r2,
                    const int* __restrict__ out_idx,
                    float* __restrict__ out_second,
                    const int* __restrict__ flag_count,
                    const int* __restrict__ flag_list) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / 8, l8 = lane % 8;
  const int chunks = (K + FC - 1) / FC;
  const long long items = (long long)*flag_count * chunks;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int o = flag_list[it / chunks], c0 = (int)(it % chunks) * FC;
    const int p = o / K, row = o % K;
    const int ia = pair_i[p], jb = pair_j[p];
    const float* a = desc + ((size_t)ia * K + row) * D;
    const float* B = desc + (size_t)jb * K * D;
    const float* xyb = xy + (size_t)jb * K * 2;
    const float* nbB = nbm + (size_t)jb * K;
    const float na = nrm[(size_t)ia * K + row];
    const int bi = out_idx[o];
    const float bx = xyb[2 * (size_t)bi], by = xyb[2 * (size_t)bi + 1];
    float sec = kInf;
    for (int cb = c0 + warp * 4; cb < c0 + FC; cb += NT / 8) {
      const bool in = cb + sub < K;
      const int c = in ? cb + sub : c0;
      const float2 pos = *reinterpret_cast<const float2*>(xyb + 2 * (size_t)c);
      const float nb = nbB[c];
      const float* b = B + (size_t)c * D;
      float cross = 0.f;
      for (int k = l8 * 4; k < D; k += 32) {
        const float4 av = *reinterpret_cast<const float4*>(a + k);
        const float4 bv = *reinterpret_cast<const float4*>(b + k);
        cross = fmaf(av.x, bv.x, cross);
        cross = fmaf(av.y, bv.y, cross);
        cross = fmaf(av.z, bv.z, cross);
        cross = fmaf(av.w, bv.w, cross);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        cross += __shfl_xor_sync(0xffffffffu, cross, off);
      const bool excl = !in || c == bi ||
                        (dup_r2 > 0.f && colocated(pos.x, pos.y, bx, by, dup_r2));
      if (!excl) sec = fminf(sec, dist2(na, nb, cross));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sec = fminf(sec, __shfl_xor_sync(0xffffffffu, sec, off));
    if (lane == 0 && sec < kInf)
      atomicMin(reinterpret_cast<int*>(out_second + o), __float_as_int(sec));
  }
}

template <int RM>
size_t smem_bytes(int Dp) {
  return ((size_t)16 * RM * (Dp + 4) + (size_t)NS * TB * SB) * sizeof(float);
}

template <int RM>
cudaError_t launch_main(const float* desc, const float* xy, const float* nrm,
                        const float* nbm, const int* pair_i, const int* pair_j,
                        int n_pairs, int K, int D, int Dp, float dup_r2,
                        int* out_idx, float* out_best, float* out_second,
                        int* flag_count, int* flag_list, cudaStream_t stream) {
  const size_t bytes = smem_bytes<RM>(Dp);
  cudaError_t err = cudaFuncSetAttribute(
      knn2_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles_a = (K + 16 * RM - 1) / (16 * RM);
  const long long blocks = (long long)n_pairs * n_tiles_a;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  knn2_kernel<RM><<<(unsigned)blocks, NT, bytes, stream>>>(
      desc, xy, nrm, nbm, pair_i, pair_j, K, D, Dp, n_tiles_a, dup_r2, out_idx,
      out_best, out_second, flag_count, flag_list);
  return cudaGetLastError();
}

// The A rows per thread (8, 4 or 2) for padded descriptor width Dp: the
// tallest A tile that fits in shared memory beside the ring, or 0 when not
// even 32 rows fit (Dp > 1216).
int rows_per_thread(int Dp) {
  if (smem_bytes<8>(Dp) <= kMaxSmem) return 8;
  if (smem_bytes<4>(Dp) <= kMaxSmem) return 4;
  if (smem_bytes<2>(Dp) <= kMaxSmem) return 2;
  return 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device pointers
// of contiguous tensors: desc (N, K, D) f32 with D a multiple of 4 and at
// most 1216, valid (N, K) u8, xy (N, K, 2) f32, pair_i / pair_j (P,) i32,
// outputs (P, K) with P * K < 2^31. Scratch: nrm and nbm (N * K) f32,
// flag_count (1) i32 (holds the number of rows the second sweep finished,
// once the launch has run), flag_list (P * K) i32. Launches on `stream` and
// returns a cudaError_t as an int.
extern "C" int knn2_launch(const float* desc, const uint8_t* valid,
                           const float* xy, const int* pair_i,
                           const int* pair_j, int n_images, int n_pairs, int K,
                           int D, float dup_r2, int* out_idx, float* out_best,
                           float* out_second, float* nrm, float* nbm,
                           int* flag_count, int* flag_list,
                           cudaStream_t stream) {
  if (n_pairs <= 0 || K <= 0) return 0;
  if (D <= 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int Dp = (D + TK - 1) / TK * TK;
  const int rm = rows_per_thread(Dp);
  if (rm == 0) return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)n_images * K;
  const long long norm_blocks = (n_rows + NT / 32 - 1) / (NT / 32);
  if (norm_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  knn2_norms_kernel<<<(unsigned)norm_blocks, NT, 0, stream>>>(
      desc, valid, n_rows, D, nrm, nbm, flag_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define KNN2_MAIN(RM)                                                        \
  launch_main<RM>(desc, xy, nrm, nbm, pair_i, pair_j, n_pairs, K, D, Dp,     \
                  dup_r2, out_idx, out_best, out_second, flag_count,         \
                  flag_list, stream)
  if (rm == 8) err = KNN2_MAIN(8);
  else if (rm == 4) err = KNN2_MAIN(4);
  else err = KNN2_MAIN(2);
#undef KNN2_MAIN
  if (err != cudaSuccess) return (int)err;
  knn2_flagged_kernel<<<1056, NT, 0, stream>>>(
      desc, xy, nrm, nbm, pair_i, pair_j, K, D, dup_r2, out_idx, out_second,
      flag_count, flag_list);
  return (int)cudaGetLastError();
}
