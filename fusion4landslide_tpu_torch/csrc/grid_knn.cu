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
//   out_d      = max(score + |q|^2, 0); out_i = original index
//                (radius filter and unsort happen in PyTorch).
//
// What bounds it on the card: not bytes (each query block reads its
// window once: nb * w_len * 20 B) but the candidate scan itself,
// n_pad * w_len score evaluations of ~8 f32 operations plus the top-k
// compare. Design: one thread per sorted query, one thread block per
// query block (all its queries share the window); the window is staged
// through shared memory in tiles of [x, y, z, |r|^2, idx] so every
// candidate is read from device memory once per block and broadcast to
// all threads; each thread keeps a register top-k (K a template constant).
//
// Traps for exact parity (see ops/hashgrid_cuda.py):
//   - block composition: padded queries are part of the blocks; the
//     prologue repeats the last sorted query to fill the final block;
//   - sort stability: the query and reference sorts are stable;
//   - top-k ties: (score, original index) order, lowest index first.
// Arithmetic is compiled with -fmad=false and the dot's fused multiply-adds
// are explicit, so each operation rounds as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;

template <int K>
__global__ void grid_knn_kernel(const float* __restrict__ qpos,  // (n_pad, 3)
                                const int* __restrict__ qrow,    // (n_pad)
                                const int* __restrict__ wmeta,   // (2, nb)
                                const float* __restrict__ refpack,  // (4, m_pad)
                                const int* __restrict__ idxarr,     // (m_pad)
                                int nb, int m_pad, int window, int chunk,
                                int k, int exclude_self,
                                float* __restrict__ out_d,  // (n_pad, k)
                                int* __restrict__ out_i) {  // (n_pad, k)
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  __shared__ float sr[kTile];
  __shared__ int si[kTile];

  const int b = blockIdx.x;
  const int row = b * blockDim.x + threadIdx.x;
  const float qx = -2.0f * qpos[3 * row + 0];
  const float qy = -2.0f * qpos[3 * row + 1];
  const float qz = -2.0f * qpos[3 * row + 2];
  const int self_row = qrow[row];
  const int w_lo = wmeta[b];
  const int w_len = wmeta[nb + b];
  int scan = ((w_len + chunk - 1) / chunk) * chunk;
  if (scan > window) scan = window;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = 0x7fffffff;
  }

  for (int t0 = 0; t0 < scan; t0 += kTile) {
    const int tn = min(kTile, scan - t0);
    __syncthreads();
    for (int p = threadIdx.x; p < tn; p += blockDim.x) {
      const int g = w_lo + t0 + p;
      sx[p] = refpack[g];
      sy[p] = refpack[m_pad + g];
      sz[p] = refpack[2 * m_pad + g];
      sr[p] = refpack[3 * m_pad + g];
      si[p] = idxarr[g];
    }
    __syncthreads();
    for (int p = 0; p < tn; ++p) {
      const float r2 = sr[p];
      if (!(r2 < CUDART_INF_F)) continue;
      const int ci = si[p];
      if (exclude_self && ci == self_row) continue;
      float s = qx * sx[p];
      s = __fmaf_rn(qy, sy[p], s);
      s = __fmaf_rn(qz, sz[p], s);
      s = s + r2;
      if (s < bd[K - 1] || (s == bd[K - 1] && ci < bi[K - 1])) {
        float vd = s;
        int vi = ci;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const bool take = vd < bd[j] || (vd == bd[j] && vi < bi[j]);
          if (take) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = vd;
            bi[j] = vi;
            vd = td;
            vi = ti;
          }
        }
      }
    }
  }

  const float px = qpos[3 * row + 0];
  const float py = qpos[3 * row + 1];
  const float pz = qpos[3 * row + 2];
  float q2 = px * px;
  q2 = q2 + py * py;
  q2 = q2 + pz * pz;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      const float d = bd[j] + q2;
      out_d[row * k + j] = d > 0.0f ? d : 0.0f;
      out_i[row * k + j] = bd[j] < CUDART_INF_F ? bi[j] : 0;
    }
  }
}

template <int K>
cudaError_t launch(const float* qpos, const int* qrow, const int* wmeta,
                   const float* refpack, const int* idxarr, int nb, int block,
                   int m_pad, int window, int chunk, int k, int exclude_self,
                   float* out_d, int* out_i, cudaStream_t stream) {
  grid_knn_kernel<K><<<nb, block, 0, stream>>>(
      qpos, qrow, wmeta, refpack, idxarr, nb, m_pad, window, chunk, k,
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
