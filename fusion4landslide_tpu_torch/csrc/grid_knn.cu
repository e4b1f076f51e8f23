// Grid-window k-nearest-neighbour search (kernel 2 of the port).
//
// Replaces: fusion4landslide_tpu/ops/hashgrid_pallas.py::_grid_knn_kernel
// (pallas_call in hash_grid_knn_window). The window prologue (query sort,
// 512-query blocks, 128-aligned contiguous candidate windows, overflow
// count) runs in PyTorch (ops/hashgrid_cuda.py::window_prologue); this
// kernel is the scan and the per-query top-k.
//
// What it computes, per cell-sorted query q of block b:
//   candidates = window positions [w_lo, w_lo + scan) with
//                scan = min(ceil(w_len / chunk) * chunk, window)
//                (the Pallas kernel's chunk-granular skip),
//   score      = -2 q.r + |r|^2 (uncentred, f32, the dot as a fused
//                multiply-add chain as XLA evaluates it; masked refs carry
//                |r|^2 = +inf and never win; optional exclude_self drops
//                the query's own original row),
//   result     = the k smallest by (score, original index): ties go to the
//                lowest original index, as in the Pallas extraction,
//   out_d      = max(score + |q|^2, 0); out_i = original index, 0 where
//                the score is +inf (radius filter and unsort happen in
//                PyTorch).
//
// What bounds it on the card: not bytes (each query block reads its
// window once: nb * w_len * 20 B) but the candidate scan itself,
// n_pad * scan score evaluations of 7 f32 operations (a product, two
// FMAs, a sum and the compare with the query's current k-th best).
//
// Design. One CTA per query block. The CTA stages its window through
// shared memory in tiles of kTile positions, as five arrays (x, y, z,
// |r|^2, original index) written by 16-byte cp.async into a two-stage
// ring: the next tile loads while the current one is scanned. The CTA's
// threads form G scan groups; every group holds all of the block's
// queries, Q contiguous sorted queries per thread (-2q, the self row and
// the (score, index) top-k lists in registers; Q = 4 up to k = 4, fewer
// as k grows), and scans every G-th run of four staged positions with one
// 16-byte shared load per array, so a load serves 4 Q evaluations. At the
// end the groups' lists are merged into group 0's by exact insertion
// through shared memory. At k = 1, G = 4 gives a CTA 16 warps and an SM
// 32 (two CTAs at 64 registers a thread): the scan is bound by latency,
// so warps count for more than queries per load. Per (query,
// run of four candidates) the hot loop is the four scores, their minimum
// and one compare with the list's worst entry (min <= worst), OR-ed over
// the thread's queries: one branch per four candidates, none on masking
// or on the self row. Masked refs score +inf, exclude_self is decided
// only for candidates that passed, and only then are the original
// indices read and the exact (score, index) insertion run. An inserted
// +inf entry (a masked or padded ref while a list is not yet full) sorts
// after every finite score and comes out as index 0 and distance +inf, as
// if it had never been inserted.
//
// Merging is exact: an original index occurs once per window (padding
// repeats index 0 with score +inf), so the (score, index) keys of a
// block's finite candidates are distinct, the union of the groups' top-k
// lists holds the block's top k, and inserting it in any order leaves the
// same k smallest finite keys.
//
// Traps for exact parity (see ops/hashgrid_cuda.py):
//   - block composition: padded queries are part of the blocks; the
//     prologue repeats the last sorted query to fill the final block;
//   - sort stability: the query and reference sorts are stable;
//   - top-k ties: (score, original index) order, lowest index first; the
//     candidate test is `<=` so an equal score reaches the exact compare.
// Arithmetic is compiled with -fmad=false and the dot's fused multiply-adds
// are explicit, so each operation rounds as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;     // window positions per stage (multiple of 4)
constexpr int kMaxBlock = 512;  // queries per block the wrapper admits

// Queries per thread: the (score, index) lists stay in registers.
constexpr int queries_per_thread(int K) { return K <= 4 ? 4 : (K <= 8 ? 2 : 1); }
// Scan groups per CTA: four at k = 1, so a CTA runs 16 warps.
constexpr int scan_groups(int K) { return K == 1 ? 4 : 1; }
constexpr int cta_threads(int K) {
  return scan_groups(K) * kMaxBlock / queries_per_thread(K);
}
// CTAs per SM the register budget is sized for: two at k = 1 (32 warps,
// at most 64 registers a thread); otherwise 512 threads a SM (at most 128
// registers a thread).
constexpr int min_ctas(int K) {
  return K == 1 ? 2 : (cta_threads(K) >= 512 ? 1 : 512 / cta_threads(K));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Exact insertion of (s, ci) into an ascending (score, index) list; the
// query's own row is dropped. Entries equal in both keys are
// interchangeable, so the list stays sorted as a multiset.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float s,
                                       int ci, int self) {
  const bool in = ci != self &&
                  (s < bd[K - 1] || (s == bd[K - 1] && ci < bi[K - 1]));
  if (!in) return;
  float vd = s;
  int vi = ci;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool take = vd < bd[j] || (vd == bd[j] && vi < bi[j]);
    const float td = bd[j];
    const int ti = bi[j];
    bd[j] = take ? vd : td;
    bi[j] = take ? vi : ti;
    vd = take ? td : vd;
    vi = take ? ti : vi;
  }
}

template <int K, int Q, int G>
__global__ void __launch_bounds__(cta_threads(K), min_ctas(K)) grid_knn_kernel(
    const float* __restrict__ qpos,     // (n_pad, 3)
    const int* __restrict__ qrow,       // (n_pad)
    const int* __restrict__ wmeta,      // (2, nb)
    const float* __restrict__ refpack,  // (4, m_pad)
    const int* __restrict__ idxarr,     // (m_pad)
    int nb, int block, int m_pad, int window, int chunk, int k,
    int exclude_self,
    float* __restrict__ out_d,  // (n_pad, k)
    int* __restrict__ out_i) {  // (n_pad, k)
  // Ring slots: x, y, z, |r|^2, index, each [2][kTile]; reused by the
  // final merge.
  __shared__ __align__(16) float smem[5 * 2 * kTile];
  static_assert((G - 1) * kMaxBlock * K * 2 <= 5 * 2 * kTile,
                "the merge buffer must fit in the staging ring");
  float* const s_x = smem;
  float* const s_y = smem + 2 * kTile;
  float* const s_z = smem + 4 * kTile;
  float* const s_r = smem + 6 * kTile;
  int* const s_i = reinterpret_cast<int*>(smem + 8 * kTile);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int per_group = nthr / G;  // threads per scan group
  const int grp = tid / per_group;
  const int lt = tid - grp * per_group;
  const int w_lo = wmeta[b];
  const int w_len = wmeta[nb + b];
  int scan = ((w_len + chunk - 1) / chunk) * chunk;
  if (scan > window) scan = window;

  // This thread's queries: -2q, the self row (-1: none; original indices
  // are >= 0) and the lists. A slot past the block holds -inf as its worst
  // entry, so no candidate reaches it.
  float mx[Q], my[Q], mz[Q];
  int self[Q];
  float bd[Q][K];
  int bi[Q][K];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const int qi = lt * Q + t;
    const bool live = qi < block;
    const int row = b * block + (live ? qi : 0);
    mx[t] = live ? -2.0f * qpos[3 * row + 0] : 0.0f;
    my[t] = live ? -2.0f * qpos[3 * row + 1] : 0.0f;
    mz[t] = live ? -2.0f * qpos[3 * row + 2] : 0.0f;
    self[t] = (live && exclude_self) ? qrow[row] : -1;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[t][j] = live ? CUDART_INF_F : -CUDART_INF_F;
      bi[t][j] = 0x7fffffff;
    }
  }

  // Stage window positions [t0, t0 + cnt) into ring slot `buf` (cnt and
  // every offset a multiple of 4: 16-byte copies).
  auto stage = [&](int buf, int t0) {
    const int cnt = min(kTile, scan - t0);
    const int g0 = w_lo + t0;
    const int o = buf * kTile;
    for (int e = 4 * tid; e < cnt; e += 4 * nthr) {
      cp_async16(s_x + o + e, refpack + g0 + e);
      cp_async16(s_y + o + e, refpack + m_pad + g0 + e);
      cp_async16(s_z + o + e, refpack + 2 * m_pad + g0 + e);
      cp_async16(s_r + o + e, refpack + 3 * m_pad + g0 + e);
      cp_async16(s_i + o + e, idxarr + g0 + e);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int ntiles = (scan + kTile - 1) / kTile;
  if (ntiles > 0) stage(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      stage(buf ^ 1, (it + 1) * kTile);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile `it` has landed for every thread's copies
    const int cnt = min(kTile, scan - it * kTile);
    const int o = buf * kTile;
    const float4* X = reinterpret_cast<const float4*>(s_x + o);
    const float4* Y = reinterpret_cast<const float4*>(s_y + o);
    const float4* Z = reinterpret_cast<const float4*>(s_z + o);
    const float4* R = reinterpret_cast<const float4*>(s_r + o);
    for (int g = grp; g < cnt / 4; g += G) {
      const float4 x4 = X[g];
      const float4 y4 = Y[g];
      const float4 z4 = Z[g];
      const float4 r4 = R[g];
      const float rx[4] = {x4.x, x4.y, x4.z, x4.w};
      const float ry[4] = {y4.x, y4.y, y4.z, y4.w};
      const float rz[4] = {z4.x, z4.y, z4.z, z4.w};
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      // Four candidates against every query, then one test per query of
      // their smallest score against the list's worst entry: one branch
      // per four candidates, and no compare waits on an insertion.
      float s[4][Q];
      bool hit = false;
#pragma unroll
      for (int t = 0; t < Q; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = mx[t] * rx[c];
          v = __fmaf_rn(my[t], ry[c], v);
          v = __fmaf_rn(mz[t], rz[c], v);
          s[c][t] = v + rr[c];
        }
        const float m = fminf(fminf(s[0][t], s[1][t]), fminf(s[2][t], s[3][t]));
        hit |= m <= bd[t][K - 1];
      }
      if (hit) {
        // Lists only improve while the four are inserted, so the test
        // against the worst entry before them admits every candidate the
        // exact insertion can take.
        const int4 i4 = reinterpret_cast<const int4*>(s_i + o)[g];
        const int ci[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int t = 0; t < Q; ++t) insert<K>(bd[t], bi[t], s[c][t], ci[c], self[t]);
        }
      }
    }
    __syncthreads();  // slot `buf` is free for tile it + 2
  }

  if (G > 1) {
    // Groups 1..G-1 hand their lists to group 0 (the ring is free: the
    // loop ended on a barrier).
    float* const m_d = smem;
    int* const m_i = reinterpret_cast<int*>(smem + (G - 1) * kMaxBlock * K);
    if (grp > 0) {
#pragma unroll
      for (int t = 0; t < Q; ++t) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int e = ((grp - 1) * kMaxBlock + lt * Q + t) * K + j;
          m_d[e] = bd[t][j];
          m_i[e] = bi[t][j];
        }
      }
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g2 = 0; g2 < G - 1; ++g2) {
#pragma unroll
      for (int t = 0; t < Q; ++t) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int e = (g2 * kMaxBlock + lt * Q + t) * K + j;
          insert<K>(bd[t], bi[t], m_d[e], m_i[e], -1);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const int qi = lt * Q + t;
    if (qi >= block) continue;
    const int row = b * block + qi;
    const float px = qpos[3 * row + 0];
    const float py = qpos[3 * row + 1];
    const float pz = qpos[3 * row + 2];
    float q2 = px * px;
    q2 = q2 + py * py;
    q2 = q2 + pz * pz;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        const float d = bd[t][j] + q2;
        out_d[row * k + j] = d > 0.0f ? d : 0.0f;
        out_i[row * k + j] = bd[t][j] < CUDART_INF_F ? bi[t][j] : 0;
      }
    }
  }
}

template <int K>
cudaError_t launch(const float* qpos, const int* qrow, const int* wmeta,
                   const float* refpack, const int* idxarr, int nb, int block,
                   int m_pad, int window, int chunk, int k, int exclude_self,
                   float* out_d, int* out_i, cudaStream_t stream) {
  constexpr int Q = queries_per_thread(K);
  constexpr int G = scan_groups(K);
  const int threads = G * ((block + Q - 1) / Q);
  grid_knn_kernel<K, Q, G><<<nb, threads, 0, stream>>>(
      qpos, qrow, wmeta, refpack, idxarr, nb, block, m_pad, window, chunk, k,
      exclude_self, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int grid_knn_launch(const void* qpos, const void* qrow,
                               const void* wmeta, const void* refpack,
                               const void* idxarr, int nb, int block,
                               int m_pad, int window, int chunk, int k,
                               int exclude_self, void* out_d, void* out_i,
                               void* stream) {
  auto* qp = static_cast<const float*>(qpos);
  auto* qr = static_cast<const int*>(qrow);
  auto* wm = static_cast<const int*>(wmeta);
  auto* rp = static_cast<const float*>(refpack);
  auto* ix = static_cast<const int*>(idxarr);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto st = static_cast<cudaStream_t>(stream);
  if (nb == 0) return 0;
  if (block < 1 || block > kMaxBlock || chunk % 4 || window % 4 || m_pad % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k <= 1) {
    err = launch<1>(qp, qr, wm, rp, ix, nb, block, m_pad, window, chunk, k,
                    exclude_self, od, oi, st);
  } else if (k <= 4) {
    err = launch<4>(qp, qr, wm, rp, ix, nb, block, m_pad, window, chunk, k,
                    exclude_self, od, oi, st);
  } else if (k <= 8) {
    err = launch<8>(qp, qr, wm, rp, ix, nb, block, m_pad, window, chunk, k,
                    exclude_self, od, oi, st);
  } else if (k <= 16) {
    err = launch<16>(qp, qr, wm, rp, ix, nb, block, m_pad, window, chunk, k,
                     exclude_self, od, oi, st);
  } else if (k <= 32) {
    err = launch<32>(qp, qr, wm, rp, ix, nb, block, m_pad, window, chunk, k,
                     exclude_self, od, oi, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
