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
// What bounds it on the card: the candidate scan, n_pad * w_len distance
// and hash evaluations (~30 integer and f32 operations each); the bytes
// (each block's window, 20 B per position, and 20 B per output slot) are
// far smaller. Design: one 128-thread block per (query block, query
// slice); thread = stratum lane, so the 128 threads read 128 consecutive
// window positions (coalesced, L1/L2 resident across the slice's
// queries) and each keeps its P/128 (key, idx, xyz) entries in registers.
// The grid's second dimension splits a query block's 512 queries into
// slices to fill the card.
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

constexpr int kLanes = 128;

__device__ __forceinline__ float hash_priority(int idx, uint32_t seed) {
  uint32_t x = static_cast<uint32_t>(idx) * 2654435761u + seed;
  x = x ^ (x >> 16);
  x = x * 0x45D9F3Bu;
  x = x ^ (x >> 16);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

template <int L>
__global__ void radius_sample_kernel(
    const float* __restrict__ qpos,     // (n_pad, 3) cell-sorted queries
    const float* __restrict__ cen,      // (nb, 3) block centres
    const float* __restrict__ r2_ptr,   // () squared radius
    const int* __restrict__ wmeta,      // (2, nb)
    const float* __restrict__ refpack,  // (4, m_pad)
    const int* __restrict__ idxarr,     // (m_pad)
    int nb, int block, int m_pad, int window, int chunk, int q_per_cta,
    uint32_t seed, int by_distance, int b0,
    int* __restrict__ out_i,     // (rows, P), rows = (b1 - b0) * block
    int* __restrict__ out_v,     // (rows, P)
    float* __restrict__ out_x) {  // (rows, P, 3)
  const int b = b0 + blockIdx.x;
  const int lane = threadIdx.x;
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

  const int q0 = blockIdx.y * q_per_cta;
  const int q1 = min(block, q0 + q_per_cta);
  for (int qi = q0; qi < q1; ++qi) {
    const int row = b * block + qi;
    const float qcx = qpos[3 * row + 0] - cx;
    const float qcy = qpos[3 * row + 1] - cy;
    const float qcz = qpos[3 * row + 2] - cz;
    const float mx = -2.0f * qcx;
    const float my = -2.0f * qcy;
    const float mz = -2.0f * qcz;
    float qc2 = qcx * qcx;
    qc2 = qc2 + qcy * qcy;
    qc2 = qc2 + qcz * qcz;

    float sk[L];
    int sid[L];
    float sxs[L], sys[L], szs[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      sk[j] = CUDART_INF_F;
      sid[j] = 0;
      sxs[j] = 0.0f;
      sys[j] = 0.0f;
      szs[j] = 0.0f;
    }

    for (int p = w_lo + lane; p < w_lo + scan; p += kLanes) {
      if (!(refpack[3 * m_pad + p] < CUDART_INF_F)) continue;
      const float x = refpack[p];
      const float y = refpack[m_pad + p];
      const float z = refpack[2 * m_pad + p];
      const float rx = x - cx;
      const float ry = y - cy;
      const float rz = z - cz;
      float r2w = rx * rx;
      r2w = r2w + ry * ry;
      r2w = r2w + rz * rz;
      float s = mx * rx;
      s = s + my * ry;
      s = s + mz * rz;
      s = s + r2w;
      const float d2 = s + qc2;
      if (!(d2 <= r2q && d2 > r2lo)) continue;
      const int ci = idxarr[p];
      float vk = by_distance ? d2 : hash_priority(ci, seed);
      if (!(vk < sk[L - 1])) continue;
      int vi = ci;
      float vx = x, vy = y, vz = z;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (vk < sk[j]) {
          const float tk = sk[j];
          const int ti = sid[j];
          const float tx = sxs[j], ty = sys[j], tz = szs[j];
          sk[j] = vk;
          sid[j] = vi;
          sxs[j] = vx;
          sys[j] = vy;
          szs[j] = vz;
          vk = tk;
          vi = ti;
          vx = tx;
          vy = ty;
          vz = tz;
        }
      }
    }

    const long long orow = static_cast<long long>(row - b0 * block);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long col = orow * P + j * kLanes + lane;
      const bool ok = sk[j] < CUDART_INF_F;
      out_i[col] = sid[j];
      out_v[col] = ok ? 1 : 0;
      out_x[3 * col + 0] = sxs[j];
      out_x[3 * col + 1] = sys[j];
      out_x[3 * col + 2] = szs[j];
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
  const int slices = 8;
  const int q_per_cta = (block + slices - 1) / slices;
  dim3 grid(b1 - b0, slices);
  radius_sample_kernel<L><<<grid, kLanes, 0, stream>>>(
      qpos, cen, r2, wmeta, refpack, idxarr, nb, block, m_pad, window, chunk,
      q_per_cta, seed, by_distance, b0, out_i, out_v, out_x);
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
