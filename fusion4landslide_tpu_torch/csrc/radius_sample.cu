// Lane-stratified in-radius sampler (kernel 1 of the port).
//
// Replaces: fusion4landslide_tpu/ops/hashgrid_pallas.py::
// _radius_sample_kernel (pallas_call in radius_sample_window). The window
// prologue runs in PyTorch (ops/hashgrid_cuda.py::window_prologue), as do
// the block centres; this kernel is the scan and the per-stratum
// selection for a range of query blocks.
//
// What it computes, per cell-sorted query q of block b and per stratum
// lane = window position mod 128:
//   candidates = positions p = lane (mod 128) in [w_lo, w_lo + scan),
//                scan = min(ceil(w_len / chunk) * chunk, window),
//   d2         = squared distance in the frame centred on the mean of the
//                block's 512 (padded) query positions, evaluated as
//                (-2 qc).rc + |rc|^2 + |qc|^2 in the Pallas kernel's order,
//   kept if      d2 <= r^2, d2 > r^2 * 1e-6 (self exclusion) and the ref
//                is valid (|r|^2 finite),
//   priority   = top-24-bit uint32 hash of (original index, seed)
//                ('random') or d2 ('distance'),
//   result     = the P/128 smallest priorities of the stratum, replacing
//                only when strictly smaller (an earlier position wins a
//                tie), written to column layer * 128 + lane with the
//                candidate's original index and coordinates.
//
// What bounds it on the card: the candidate scan, n_pad * w_len (query,
// position) evaluations of ~9 f32 operations (the 7 of d2 and the two
// tests) plus ~12 per (block, position) for the centring, |r|^2 and the
// hash; the bytes (each block's window, 20 B per position, and 20 B per
// output slot) are far smaller. Design: one CTA of 4 x 128 threads per
// (query block, slice of 32 queries); thread = (query group, stratum
// lane), holding kQt = 8 queries (-2 qc, |qc|^2 and its P/128 (key,
// position) entries in registers). The CTA stages the window 2048
// positions at a time in shared memory as per-position records computed
// once: centred rx, ry, rz, |r|^2 in the frame (NaN for masked refs) and
// the 'random' priority; the raw words of the next stage are fetched into
// registers while the current one is scanned. Per (query, position) only
// the 3-term dot, d2, the two tests and a rare insertion remain; the
// original index and xyz of a kept slot are read once, at the end. The
// hoisted terms depend only on (block, position), so no rounding changes.
//
// Traps for exact parity (see ops/hashgrid_cuda.py):
//   - block composition: padded queries take part in the block mean;
//     every padding step of the callers is reproduced, and the prologue
//     repeats the last sorted query to fill the final block;
//   - sort stability: the query and reference sorts are stable;
//   - strict replacement: equal priorities keep the earlier position;
//   - the hash is uint32 arithmetic (the plain version masks int64).
// Arithmetic is compiled with -fmad=false, so each product and sum rounds
// on its own, as in the plain PyTorch version (and as the interpret-mode
// Pallas kernel evaluates this 3-term dot).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;    // strata: window position mod 128
constexpr int kGroups = 4;     // query groups per CTA
constexpr int kQt = 8;         // queries per thread
constexpr int kThreads = kLanes * kGroups;
constexpr int kQueriesPerCta = kGroups * kQt;
constexpr int kStage = 2048;   // window positions staged at a time
constexpr int kPer = kStage / kThreads;

__device__ __forceinline__ float hash_priority(int idx, uint32_t seed) {
  uint32_t x = static_cast<uint32_t>(idx) * 2654435761u + seed;
  x = x ^ (x >> 16);
  x = x * 0x45D9F3Bu;
  x = x ^ (x >> 16);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

template <int K>
__device__ __forceinline__ void insert(float (&sk)[K], int (&sp)[K], float vk,
                                       int vp) {
  // Strict replacement: the new entry goes before the first strictly
  // larger key, so an equal key never displaces an earlier position, and
  // every later entry moves down one slot (in order, equal keys included).
  bool shift = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (shift || vk < sk[j]) {
      shift = true;
      const float tk = sk[j];
      const int tp = sp[j];
      sk[j] = vk;
      sp[j] = vp;
      vk = tk;
      vp = tp;
    }
  }
}

template <int L, bool kByDistance>
__global__ void __launch_bounds__(kThreads, 1) radius_sample_kernel(
    const float* __restrict__ qpos,     // (n_pad, 3) cell-sorted queries
    const float* __restrict__ cen,      // (nb, 3) block centres
    const float* __restrict__ r2_ptr,   // () squared radius
    const int* __restrict__ wmeta,      // (2, nb)
    const float* __restrict__ refpack,  // (4, m_pad)
    const int* __restrict__ idxarr,     // (m_pad)
    int nb, int block, int m_pad, int window, int chunk, uint32_t seed, int b0,
    int* __restrict__ out_i,     // (rows, P), rows = (b1 - b0) * block
    int* __restrict__ out_v,     // (rows, P)
    float* __restrict__ out_x) {  // (rows, P, 3)
  __shared__ float s_rx[kStage], s_ry[kStage], s_rz[kStage], s_r2[kStage], s_pri[kStage];
  const int b = b0 + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int P = L * kLanes;
  const float r2q = *r2_ptr;
  const float r2lo = r2q * 1e-6f;
  const float cx = cen[3 * b + 0];
  const float cy = cen[3 * b + 1];
  const float cz = cen[3 * b + 2];
  const int w_lo = wmeta[b];
  const int w_len = wmeta[nb + b];
  int scan = ((w_len + chunk - 1) / chunk) * chunk;
  if (scan > window) scan = window;

  // This thread's queries: centred, -2 qc and |qc|^2; NaN |qc|^2 (no
  // candidate passes either test) past the block.
  const int qbase = blockIdx.y * kQueriesPerCta + (tid / kLanes) * kQt;
  float mx[kQt], my[kQt], mz[kQt], qc2[kQt];
  float sk[kQt][L];
  int sp[kQt][L];
#pragma unroll
  for (int t = 0; t < kQt; ++t) {
    const int qi = qbase + t;
    mx[t] = my[t] = mz[t] = 0.0f;
    qc2[t] = CUDART_NAN_F;
    if (qi < block) {
      const int row = b * block + qi;
      const float qcx = qpos[3 * row + 0] - cx;
      const float qcy = qpos[3 * row + 1] - cy;
      const float qcz = qpos[3 * row + 2] - cz;
      mx[t] = -2.0f * qcx;
      my[t] = -2.0f * qcy;
      mz[t] = -2.0f * qcz;
      float q2 = qcx * qcx;
      q2 = q2 + qcy * qcy;
      q2 = q2 + qcz * qcz;
      qc2[t] = q2;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      sk[t][j] = CUDART_INF_F;
      sp[t][j] = 0;
    }
  }

  // Raw words of this thread's positions of the next stage.
  float fx[kPer], fy[kPer], fz[kPer], fr[kPer];
  int fi[kPer];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int pl = c0 + tid + u * kThreads;
      if (pl < scan) {
        const int p = w_lo + pl;
        fx[u] = refpack[p];
        fy[u] = refpack[m_pad + p];
        fz[u] = refpack[2 * m_pad + p];
        fr[u] = refpack[3 * m_pad + p];
        fi[u] = kByDistance ? 0 : idxarr[p];
      }
    }
  };
  fetch(0);

  for (int c0 = 0; c0 < scan; c0 += kStage) {
    const int cnt = min(kStage, scan - c0);
    __syncthreads();  // the previous stage has been scanned
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int pl = tid + u * kThreads;
      if (pl < cnt) {
        const float rx = fx[u] - cx;
        const float ry = fy[u] - cy;
        const float rz = fz[u] - cz;
        float r2w = rx * rx;
        r2w = r2w + ry * ry;
        r2w = r2w + rz * rz;
        s_rx[pl] = rx;
        s_ry[pl] = ry;
        s_rz[pl] = rz;
        // A masked ref: NaN, so d2 = NaN fails both tests.
        s_r2[pl] = fr[u] < CUDART_INF_F ? r2w : CUDART_NAN_F;
        s_pri[pl] = kByDistance ? 0.0f : hash_priority(fi[u], seed);
      }
    }
    __syncthreads();
    if (c0 + kStage < scan) fetch(c0 + kStage);

    for (int pl = lane; pl < cnt; pl += kLanes) {
      const float rx = s_rx[pl];
      const float ry = s_ry[pl];
      const float rz = s_rz[pl];
      const float r2w = s_r2[pl];
      const float pri = s_pri[pl];
#pragma unroll
      for (int t = 0; t < kQt; ++t) {
        float s = mx[t] * rx;
        s = s + my[t] * ry;
        s = s + mz[t] * rz;
        s = s + r2w;
        const float d2 = s + qc2[t];
        if (d2 <= r2q && d2 > r2lo) {
          const float vk = kByDistance ? d2 : pri;
          if (vk < sk[t][L - 1]) insert<L>(sk[t], sp[t], vk, c0 + pl);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kQt; ++t) {
    const int qi = qbase + t;
    if (qi >= block) continue;
    const long long orow = static_cast<long long>(b - b0) * block + qi;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long col = orow * P + j * kLanes + lane;
      const bool ok = sk[t][j] < CUDART_INF_F;
      const int p = w_lo + sp[t][j];
      out_i[col] = ok ? idxarr[p] : 0;
      out_v[col] = ok ? 1 : 0;
      out_x[3 * col + 0] = ok ? refpack[p] : 0.0f;
      out_x[3 * col + 1] = ok ? refpack[m_pad + p] : 0.0f;
      out_x[3 * col + 2] = ok ? refpack[2 * m_pad + p] : 0.0f;
    }
  }
}

template <int L>
cudaError_t launch(const float* qpos, const float* cen, const float* r2,
                   const int* wmeta, const float* refpack, const int* idxarr,
                   int nb, int block, int m_pad, int window, int chunk,
                   uint32_t seed, int by_distance, int b0, int b1,
                   int* out_i, int* out_v, float* out_x,
                   cudaStream_t stream) {
  dim3 grid(b1 - b0, (block + kQueriesPerCta - 1) / kQueriesPerCta);
  if (by_distance) {
    radius_sample_kernel<L, true><<<grid, kThreads, 0, stream>>>(
        qpos, cen, r2, wmeta, refpack, idxarr, nb, block, m_pad, window, chunk,
        seed, b0, out_i, out_v, out_x);
  } else {
    radius_sample_kernel<L, false><<<grid, kThreads, 0, stream>>>(
        qpos, cen, r2, wmeta, refpack, idxarr, nb, block, m_pad, window, chunk,
        seed, b0, out_i, out_v, out_x);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int radius_sample_launch(
    const void* qpos, const void* cen, const void* r2, const void* wmeta,
    const void* refpack, const void* idxarr, int nb, int block, int m_pad,
    int window, int chunk, int num_points, unsigned int seed, int by_distance,
    int b0, int b1, void* out_i, void* out_v, void* out_x, void* stream) {
  auto* qp = static_cast<const float*>(qpos);
  auto* ce = static_cast<const float*>(cen);
  auto* rr = static_cast<const float*>(r2);
  auto* wm = static_cast<const int*>(wmeta);
  auto* rp = static_cast<const float*>(refpack);
  auto* ix = static_cast<const int*>(idxarr);
  auto* oi = static_cast<int*>(out_i);
  auto* ov = static_cast<int*>(out_v);
  auto* ox = static_cast<float*>(out_x);
  auto st = static_cast<cudaStream_t>(stream);
  if (b1 <= b0) return 0;
  cudaError_t err;
  switch (num_points / kLanes) {
    case 1:
      err = launch<1>(qp, ce, rr, wm, rp, ix, nb, block, m_pad, window, chunk,
                      seed, by_distance, b0, b1, oi, ov, ox, st);
      break;
    case 2:
      err = launch<2>(qp, ce, rr, wm, rp, ix, nb, block, m_pad, window, chunk,
                      seed, by_distance, b0, b1, oi, ov, ox, st);
      break;
    case 4:
      err = launch<4>(qp, ce, rr, wm, rp, ix, nb, block, m_pad, window, chunk,
                      seed, by_distance, b0, b1, oi, ov, ox, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
