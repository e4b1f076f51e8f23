// Exact brute-force k-nearest-neighbour search in feature space (kernel 3
// of the port).
//
// Replaces: fusion4landslide_tpu/ops/knn_pallas.py::_knn_kernel (pallas_call
// in knn_pallas). The wrapper (ops/knn_cuda.py) computes |q|^2 and |r|^2
// once, with a sequential sum over d, masks refs by |r|^2 = +inf and pads
// the feature width to kD = 64 (the DIPs descriptor width of every caller)
// with zero columns (exact: each zero column adds +0 to the dot product).
//
// What it computes, for query row i and ref row j (global indices):
//   score(i, j) = |r_j|^2 - 2 q_i.r_j   (no |q|^2, no clamp: the Pallas
//                 kernel selects on this raw score), the dot product a
//                 fixed-order chain acc = acc + q[d] * r[d], d ascending,
//                 each product and sum rounded on its own (-fmad=false);
//                 +inf for exclude_self when i == j;
//   result      = the k smallest scores by (score, ref index): ties go to
//                 the lowest ref index, as the Pallas kernel's strict-<
//                 per-lane insertion plus minimum-index extraction give;
//   out_d       = max(score + |q|^2, 0); out_i = ref index, 0 wherever the
//                 distance is +inf (masked refs, k past the valid refs).
//
// What bounds it on the card: operations. n * m * D multiply-adds (2 f32
// operations each) against n * D + m * D + 2 n k words of traffic; at the
// F2S3 tile (n = m = 524288, D = 64) that is 3.5e13 operations for 0.27 GB.
// Design (a simple first kernel): one thread per query with its row in
// registers; refs staged through shared memory in tiles of kTileR rows, so
// each block reads the ref array once and every thread reads a ref value as
// a broadcast; four refs per step give four independent dot chains; each
// thread keeps a sorted register top-K (K a template constant, k rounded up
// to a power of two), and a candidate is inserted only when it beats the
// K-th score. No tensor cores: TF32 flips near-tie matches, and the
// reference runs the dot at full f32 (Precision.HIGHEST).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // queries per block
constexpr int kTileR = 64;     // refs per shared-memory tile (multiple of 4)
constexpr int kD = 64;         // feature width (the wrapper zero-pads to it)
constexpr int kD4 = kD / 4;

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float vd,
                                       int vi) {
  // Bubble insertion: layer l ends holding the (l+1)-th smallest score.
  // Refs arrive in ascending index order and the test is strict, so an
  // equal score never displaces an earlier index. Unrolled (the list stays
  // in registers) up to K = 32; larger lists live in local memory.
#pragma unroll(K <= 32 ? K : 1)
  for (int l = 0; l < K; ++l) {
    if (vd < bd[l]) {
      const float td = bd[l];
      const int ti = bi[l];
      bd[l] = vd;
      bi[l] = vi;
      vd = td;
      vi = ti;
    }
  }
}

__device__ __forceinline__ float dot4(float acc, const float4 a,
                                      const float4 b) {
  acc = acc + a.x * b.x;
  acc = acc + a.y * b.y;
  acc = acc + a.z * b.z;
  acc = acc + a.w * b.w;
  return acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float4* __restrict__ q,   // (n, kD)
               const float* __restrict__ q2,   // (n)
               const float4* __restrict__ r,   // (m, kD)
               const float* __restrict__ r2,   // (m), +inf where masked
               int n, int m, int k, int exclude_self,
               float* __restrict__ out_d,      // (n, k)
               int* __restrict__ out_i) {      // (n, k)
  __shared__ float4 s_r[kTileR * kD4];
  __shared__ float s_r2[kTileR];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  float4 qv[kD4];
#pragma unroll
  for (int d4 = 0; d4 < kD4; ++d4) {
    qv[d4] = live ? q[static_cast<size_t>(row) * kD4 + d4]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    bd[l] = CUDART_INF_F;
    bi[l] = 0;
  }

  for (int j0 = 0; j0 < m; j0 += kTileR) {
    const int cnt = min(kTileR, m - j0);
    __syncthreads();
    for (int p = threadIdx.x; p < kTileR * kD4; p += kThreads) {
      const int jj = p / kD4;
      s_r[p] = jj < cnt ? r[static_cast<size_t>(j0 + jj) * kD4 + (p - jj * kD4)]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int p = threadIdx.x; p < kTileR; p += kThreads) {
      s_r2[p] = p < cnt ? r2[j0 + p] : CUDART_INF_F;
    }
    __syncthreads();
    for (int jj = 0; jj < cnt; jj += 4) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kD4; ++d4) {
        a0 = dot4(a0, qv[d4], s_r[(jj + 0) * kD4 + d4]);
        a1 = dot4(a1, qv[d4], s_r[(jj + 1) * kD4 + d4]);
        a2 = dot4(a2, qv[d4], s_r[(jj + 2) * kD4 + d4]);
        a3 = dot4(a3, qv[d4], s_r[(jj + 3) * kD4 + d4]);
      }
      const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + jj + u;
        float s = s_r2[jj + u] - 2.0f * acc[u];
        if (exclude_self && j == row) s = CUDART_INF_F;
        if (jj + u < cnt && s < bd[K - 1]) insert<K>(bd, bi, s, j);
      }
    }
  }

  if (!live) return;
  const float qq = q2[row];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    if (l < k) {
      const float d = bd[l] + qq;
      const bool fin = d < CUDART_INF_F;
      out_d[static_cast<size_t>(row) * k + l] = d > 0.0f ? d : 0.0f;
      out_i[static_cast<size_t>(row) * k + l] = fin ? bi[l] : 0;
    }
  }
}

template <int K>
cudaError_t launch(const void* q, const void* q2, const void* r,
                   const void* r2, int n, int m, int k, int exclude_self,
                   void* out_d, void* out_i, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(q), static_cast<const float*>(q2),
      static_cast<const float4*>(r), static_cast<const float*>(r2), n, m, k,
      exclude_self, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return cudaGetLastError();
}

}  // namespace

// q (n, 64) and r (m, 64) row-major float32; q2 (n), r2 (m) float32;
// out_d (n, k) float32, out_i (n, k) int32; 1 <= k <= 128; the list length
// K is k rounded up to a power of two. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int knn_launch(const void* q, const void* q2, const void* r,
                          const void* r2, int n, int m, int k,
                          int exclude_self, void* out_d, void* out_i,
                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (k < 1 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (k <= 1) err = launch<1>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 2) err = launch<2>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 4) err = launch<4>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 8) err = launch<8>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 16) err = launch<16>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 32) err = launch<32>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 64) err = launch<64>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else if (k <= 128) err = launch<128>(q, q2, r, r2, n, m, k, exclude_self, out_d, out_i, st);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
