// Exact brute-force k-nearest-neighbour search in feature space (kernel 3
// of the port): a TF32 tensor-core filter with exact float32 rescoring.
//
// Replaces: fusion4landslide_tpu/ops/knn_pallas.py::_knn_kernel (pallas_call
// in knn_pallas). Like the Pallas kernel, which forms each (query block x
// ref block) score tile on the matrix unit and folds it into a running
// top-k with the ref axis innermost, each CTA keeps a 128-row query tile in
// shared memory, streams 128-ref tiles through a two-stage cp.async ring,
// forms the score tile with Hopper's warpgroup MMA (wgmma, TF32 in, float32
// accumulation) and folds it into per-thread top-K lists.
//
// What it computes, for query row i and ref row j (global indices):
//   score(i, j) = |r_j|^2 - 2 q_i.r_j   (no |q|^2, no clamp: the Pallas
//                 kernel selects on this raw score), the dot product the
//                 fixed-order chain acc = acc + q[d] * r[d], d ascending,
//                 each product and sum rounded on its own (-fmad=false);
//                 +inf for exclude_self when i == j; masked refs carry
//                 |r|^2 = +inf;
//   result      = the k smallest scores by (score, ref index);
//   out_d       = max(score + |q|^2, 0); out_i = ref index, 0 wherever the
//                 distance is +inf (masked refs, k past the valid refs).
// Any split of the ref axis gives this result as long as every merge
// compares (score, index) lexicographically, so each thread keeps its own
// list over the columns it holds and the four threads of a row merge at
// the end.
//
// The filter. The wrapper (ops/knn_cuda.py::filter_terms) centres both
// sides on one vector mu (the mean of the unmasked refs where they cluster,
// sum |r - mu|^2 <= sum |r|^2 / 16; else mu = 0): a = fl(q - mu),
// b = fl(r - mu), and splits each value x of a and b into hi = x with the
// low 13 mantissa bits cleared (a TF32 number) and lo = x - hi (exact, so
// hi + lo == x). The tensor cores form c'_ij = sum_d lo hi + hi lo + hi hi
// ("3xTF32") ~ a_i.b_j. With s_ij the exact chain above, real arithmetic
// gives |r|^2 - 2 q.r = (|b|^2 - 2 a.b) + C_i + R_ij with the row constant
// C_i = -|mu|^2 - 2 a_i.mu - 2 e_i.mu (e_i = q_i - mu - a_i, |e_i| <= u|a_i|)
// and |R_ij| <= 2u (2|a||b| + |b|^2). Centring keeps the tensor cores'
// error on the small |a||b| (descriptors cluster: for the F2S3 tile's
// random-init DIPs descriptors |a| ~ 0.04 |q|) instead of |q||r|.
//
// The certified margin (u = 2^-24; sum_d |x_d y_d| <= |x||y|):
//   |s_ij - (|r|^2 - 2 q.r)| <= 131 u (|q||r| + |r|^2)   the chain's 64
//       roundings in the dot and in |r|^2 (gamma_64 each) and the final
//       subtraction;
//   |c' - a.b| <= 433.4 u |a||b|   the dropped lo.lo term and the TF32
//       rounding of lo in the cross terms (each below 2^-20 |a_d b_d|), and
//       the tensor core's float32 accumulation of 192 exact products,
//       allowing each addition twice the usual error (2u, truncation);
//   |fl(|b|^2 - 2 c') - (|b|^2 - 2 a.b)| <= 870 u |a||b| + 2 u |b|^2, with
//       |b|^2 from the wrapper in float64, and |R| as above.
// So with eps1 = 2^-16 = 256 u and eps2 = 2^-13 = 2048 u, about twice each
// sum,
//   s_ij >= A_j - 2 c'_ij - W_j P_i + B_i,
//   A_j = |b_j|^2 - eps1 |r_j|^2 - eps2 |b_j|^2,  W_j = eps1 |r_j| + eps2 |b_j|,
//   P_i = max(|q_i|, |a_i|),  B_i = C'_i - eps1 (|C'_i| + 2 |a_i||mu|),
// with C'_i = -|mu|^2 - 2 a_i.mu in float64 (|e_i.mu| <= u|a_i||mu|). The
// float32 roundings of A, W, P, B and of the kernel's two FMAs stay inside
// the two factors of two. The bound needs no product to underflow
// (nonzero |x| above ~1e-15).
//
// Exact rescoring. Per row the kernel keeps thr = an upper bound of
// bd[K-1] - B_i (bd[K-1] the thread's current exact K-th best; for K = 1
// the best of the row's four threads). A candidate is rescored only if
// lower_ij = A_j - 2 c'_ij - W_j P_i <= thr: then s_ij is recomputed with
// the unfused chain from the raw rows and inserted with the strict-< rule.
// A skipped candidate has s_ij > bd, so it could not have entered (nor tied
// the row's best), so the exact chain decides every selection and the
// output is bit-equal to the plain version: TF32 can no longer flip a
// near-tie. Masked refs (A = NaN) and exclude_self diagonals never enter a
// list. ``rescored`` counts the rescored candidates of a launch. A row of
// zeros (P_i = -1) is skipped: its exact scores are the |r_j|^2 themselves,
// so near-equal norms would send every ref through rescoring, and the
// wrapper answers it from |r|^2 directly (the F2S3 step's padded rows).
//
// What bounds it on the card: operations, on the tensor cores: 3 x 2 n m D
// TF32 flops (m the refs up to the last unmasked one; the kernel skips the
// masked tail) against n D + m D words; the epilogue adds two FMAs and a
// min per (i, j) on the CUDA cores.
// Design: 256 threads = two consumer warpgroups, each owning 64 query rows
// (wgmma m64n128k8, 64 f32 accumulators per thread, 24 MMAs per ref tile);
// both operands K-major in 128-byte-swizzled shared memory (query tile
// 64 KB, each ref stage 64 KB + the per-ref terms); one CTA per SM. Each
// thread holds two rows x 32 columns of a tile and a sorted top-K list per
// row (in registers up to K = 8, in local memory above). A branch-free
// pass takes each row's smallest lower bound; only a row where it reaches
// the threshold walks its candidates again.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // feature width (the wrapper zero-pads to it)
constexpr int kRowsQ = 128;     // query rows per CTA (two warpgroups x 64)
constexpr int kTileR = 128;     // refs per stage (the wgmma N)
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kAtom = 128 * 128;          // one swizzled (128 rows x 32 f32) atom
constexpr int kTileBytes = 4 * kAtom;     // [hi, lo] x two 32-wide K atoms
constexpr int kMetaBytes = 3 * kTileR * 4;  // |r|^2, A, W of a stage
constexpr float kThrSlack = 1.0f / 4194304.0f;  // 2^-22: covers bd - B's rounding
constexpr int kSmemBytes = 1024 + kTileBytes + kStages * (kTileBytes + kMetaBytes);

// Byte offset of 16-byte chunk kc (0..15 along the 64 values) of part
// (0 = hi, 1 = lo) of a tile row, in the 128-byte swizzle wgmma reads:
// chunk c of row r sits at chunk c ^ (r & 7) of the row's 128 bytes.
__device__ __forceinline__ uint32_t swz(int part, int kc, int row) {
  return (part * 2 + (kc >> 3)) * kAtom + row * 128 + (((kc & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// A (kTileR or kRowsQ = 128)-row tile of [hi | lo] rows into swizzled
// shared memory, 16 chunks of each part per row.
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src) {
  for (int c = threadIdx.x; c < 128 * 32; c += kThreads) {
    const int row = c >> 5, kc2 = c & 31;
    cp16(dst + swz(kc2 >> 4, kc2 & 15, row), src + static_cast<size_t>(row) * 128 + kc2 * 4);
  }
}

__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  // K-major, 128-byte swizzle: start >> 4, LBO unused (1), SBO = 1024 B
  // between 8-row groups, layout type 1 (SWIZZLE_128B).
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float vd,
                                       int vi) {
  // Insertion: the new entry goes before the first strictly larger score
  // and every later entry moves down one slot. A thread meets its refs in
  // ascending index order, so an equal score never displaces an earlier
  // index. (Moving each displaced entry on only past strictly larger
  // scores would reorder two equal scores behind it.) Unrolled (the list
  // stays in registers) up to K = 8; longer lists live in local memory.
  bool shift = false;
#pragma unroll(K <= 8 ? K : 1)
  for (int l = 0; l < K; ++l) {
    if (shift || vd < bd[l]) {
      shift = true;
      const float td = bd[l];
      const int ti = bi[l];
      bd[l] = vd;
      bi[l] = vi;
      vd = td;
      vi = ti;
    }
  }
}

// The exact score of raw rows q and r (device memory, width kD): the
// unfused chain acc = acc + q[d] * r[d], then |r|^2 - 2 acc.
__device__ __noinline__ float exact_score(const float* __restrict__ q,
                                          const float* __restrict__ r, float r2) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* r4 = reinterpret_cast<const float4*>(r);
  float acc = 0.0f;
#pragma unroll 4
  for (int c = 0; c < kD / 4; ++c) {
    const float4 a = __ldg(q4 + c);
    const float4 b = __ldg(r4 + c);
    acc = acc + a.x * b.x;
    acc = acc + a.y * b.y;
    acc = acc + a.z * b.z;
    acc = acc + a.w * b.w;
  }
  return r2 - 2.0f * acc;
}

// The filter's threshold for a row whose current K-th best exact score is
// bd: an upper bound on bd - B (primed domain), +inf while the list has room.
__device__ __forceinline__ float primed(float bd, float b) {
  if (!(bd < CUDART_INF_F)) return CUDART_INF_F;
  const float t = bd - b;
  return t + kThrSlack * (fabsf(bd) + fabsf(b));
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    knn_kernel(const float* __restrict__ qpack,  // (n_pad, 128) centred [hi | lo]
               const float* __restrict__ rpack,  // (m_pad, 128) centred [hi | lo]
               const float* __restrict__ qraw,   // (n_pad, 64) queries
               const float* __restrict__ rraw,   // (m_pad, 64) refs
               const float* __restrict__ q2,     // (n) |q|^2
               const float* __restrict__ qp,     // (n_pad) P_i, -1: skip the row
               const float* __restrict__ qb,     // (n_pad) B_i
               const float* __restrict__ r2,     // (m_pad) |r|^2, +inf masked
               const float* __restrict__ ra,     // (m_pad) A_j, NaN masked
               const float* __restrict__ rw,     // (m_pad) W_j
               const int* __restrict__ m_live,   // () last unmasked ref + 1
               int n, int k, int exclude_self,
               float* __restrict__ out_d,        // (n, k)
               int* __restrict__ out_i,          // (n, k)
               unsigned long long* __restrict__ rescored) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t s_q = raw + pad;
  const uint32_t s_r = s_q + kTileBytes;  // stage s at s_r + s * kTileBytes
  const uint32_t s_meta = s_r + kStages * kTileBytes;
  const float* const meta =
      reinterpret_cast<const float*>(smem_raw + pad + kTileBytes * (1 + kStages));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * kRowsQ;
  const int row[2] = {q0 + wg * 64 + warp * 16 + g, q0 + wg * 64 + warp * 16 + g + 8};
  const float pr[2] = {qp[row[0]], qp[row[1]]};
  const float br[2] = {qb[row[0]], qb[row[1]]};
  const int tiles = (*m_live + kTileR - 1) / kTileR;

  auto load_stage = [&](int s, int j0) {
    load_tile(s_r + s * kTileBytes, rpack + static_cast<size_t>(j0) * 128);
    if (tid < 96) {
      const float* src = (tid < 32 ? r2 : tid < 64 ? ra : rw) + j0 + (tid & 31) * 4;
      cp16(s_meta + s * kMetaBytes + tid * 16, src);
    }
  };

  load_tile(s_q, qpack + static_cast<size_t>(q0) * 128);
  if (tiles > 0) load_stage(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float bd[2][K];
  int bi[2][K];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      bd[h][l] = CUDART_INF_F;
      bi[h][l] = 0;
    }
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  unsigned int n_rescored = 0;

  for (int t = 0; t < tiles; ++t) {
    const int s = t & 1;
    const int j0 = t * kTileR;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // cp.async writes are generic-proxy writes; wgmma reads through the
    // async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // The other stage's tile was consumed before the barrier.
    if (t + 1 < tiles) load_stage(s ^ 1, j0 + kTileR);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint32_t a_base = s_q + wg * 64 * 128;
    const uint32_t b_base = s_r + s * kTileBytes;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const uint32_t off = (ks >> 2) * kAtom + (ks & 3) * 32;
      const uint64_t ah = desc(a_base + off), al = desc(a_base + 2 * kAtom + off);
      const uint64_t bh = desc(b_base + off), bl = desc(b_base + 2 * kAtom + off);
      wgmma_tf32(d, al, bh, ks > 0);
      wgmma_tf32(d, ah, bl, 1);
      wgmma_tf32(d, ah, bh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);

    // Accumulator layout (m64nN, f32): register 4 jc + 2 h + e holds row
    // 16 warp + g + 8 h, column 8 jc + 2 tq + e of the warpgroup's tile.
    // Fast pass, branch-free: the smallest lower bound of each row,
    // lower_ij = A_j - 2 c'_ij - W_j P_i (see the margin above).
    const float* m_r2 = meta + s * (kMetaBytes / 4);
    const float* m_a = m_r2 + kTileR;
    const float* m_w = m_a + kTileR;
    float lowest[2] = {CUDART_INF_F, CUDART_INF_F};
#pragma unroll
    for (int jc = 0; jc < kTileR / 8; ++jc) {
      const float2 ca = *reinterpret_cast<const float2*>(m_a + 8 * jc + 2 * tq);
      const float2 cw = *reinterpret_cast<const float2*>(m_w + 8 * jc + 2 * tq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lower = __fmaf_rn(-2.0f, d[4 * jc + 2 * h + e], e ? ca.y : ca.x);
          lower = __fmaf_rn(-(e ? cw.y : cw.x), pr[h], lower);
          lowest[h] = fminf(lowest[h], lower);
        }
      }
    }
    // Slow pass, for a row where some candidate may enter: each candidate
    // in index order against the row's threshold, exact rescoring,
    // strict-< insertion. For K = 1 the threshold is the quad's best (a
    // candidate strictly worse than another thread's best can never be
    // the row's nearest; equal ones are rescored, for the index order).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float base = bd[h][K - 1];
      if (K == 1) {
        base = fminf(base, __shfl_xor_sync(0xffffffffu, base, 1));
        base = fminf(base, __shfl_xor_sync(0xffffffffu, base, 2));
      }
      float thr = primed(base, br[h]);
      if (pr[h] >= 0.0f && lowest[h] <= thr) {
#pragma unroll
        for (int jc = 0; jc < kTileR / 8; ++jc) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * jc + 2 * tq + e;
            float lower = __fmaf_rn(-2.0f, d[4 * jc + 2 * h + e], m_a[col]);
            lower = __fmaf_rn(-m_w[col], pr[h], lower);
            if (lower <= thr) {
              ++n_rescored;
              const int j = j0 + col;
              float sc = exact_score(qraw + static_cast<size_t>(row[h]) * kD,
                                     rraw + static_cast<size_t>(j) * kD, m_r2[col]);
              if (exclude_self && row[h] == j) sc = CUDART_INF_F;
              if (sc < bd[h][K - 1]) {
                insert<K>(bd[h], bi[h], sc, j);
                thr = fminf(thr, primed(bd[h][K - 1], br[h]));
              }
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  for (int off = 16; off > 0; off >>= 1) {
    n_rescored += __shfl_xor_sync(0xffffffffu, n_rescored, off);
  }
  if (lane == 0) atomicAdd(rescored, static_cast<unsigned long long>(n_rescored));

  // Merge the four lists of each row (threads tq = 0..3 of a quad) by
  // (score, index): the quad's smallest head is popped k times.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float qq = row[h] < n ? q2[row[h]] : 0.0f;
    for (int l = 0; l < k; ++l) {
      float md = bd[h][0];
      int mi = bi[h][0];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (od < md || (od == md && oi < mi)) {
          md = od;
          mi = oi;
        }
      }
      if (tq == 0 && row[h] < n) {
        const float dd = md + qq;
        out_d[static_cast<size_t>(row[h]) * k + l] = dd > 0.0f ? dd : 0.0f;
        out_i[static_cast<size_t>(row[h]) * k + l] = dd < CUDART_INF_F ? mi : 0;
      }
      if (bd[h][0] == md && bi[h][0] == mi) {
#pragma unroll
        for (int p = 0; p + 1 < K; ++p) {
          bd[h][p] = bd[h][p + 1];
          bi[h][p] = bi[h][p + 1];
        }
        bd[h][K - 1] = CUDART_INF_F;
        bi[h][K - 1] = 0;
      }
    }
  }
}

template <int K>
cudaError_t launch(const void* qpack, const void* rpack, const void* qraw,
                   const void* rraw, const void* q2, const void* qp, const void* qb,
                   const void* r2, const void* ra, const void* rw, const void* m_live,
                   int n, int n_pad, int k, int exclude_self, void* out_d,
                   void* out_i, void* rescored, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  knn_kernel<K><<<n_pad / kRowsQ, kThreads, kSmemBytes, stream>>>(
      f(qpack), f(rpack), f(qraw), f(rraw), f(q2), f(qp), f(qb), f(r2), f(ra),
      f(rw), static_cast<const int*>(m_live), n, k, exclude_self,
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<unsigned long long*>(rescored));
  return cudaGetLastError();
}

}  // namespace

// qpack (n_pad, 128) and rpack (m_pad, 128): float32 rows [hi(64) | lo(64)]
// of the centred a = q - mu and b = r - mu; qraw (n_pad, 64) and rraw
// (m_pad, 64) the raw rows; n_pad and m_pad multiples of 128, m_pad
// covering *m_live; q2 (n) |q|^2; qp, qb (n_pad) P_i and B_i; r2 (m_pad)
// |r|^2 (+inf masked), ra (m_pad) A_j (NaN masked), rw (m_pad) W_j (terms
// of the margin above, formed by ops/knn_cuda.py::filter_terms); m_live ()
// int32; out_d (n, k) float32, out_i (n, k) int32; rescored () uint64,
// added to; 1 <= k <= 128, the list length K is k rounded up to a power of
// two. Returns the cudaError_t of the launch (0 on success).
extern "C" int knn_launch(const void* qpack, const void* rpack, const void* qraw,
                          const void* rraw, const void* q2, const void* qp,
                          const void* qb, const void* r2, const void* ra,
                          const void* rw, const void* m_live, int n, int n_pad,
                          int k, int exclude_self, void* out_d, void* out_i,
                          void* rescored, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (k < 1 || n_pad % kRowsQ || n_pad < n) return static_cast<int>(cudaErrorInvalidValue);
#define KNN_LAUNCH(KK)                                                       \
  launch<KK>(qpack, rpack, qraw, rraw, q2, qp, qb, r2, ra, rw, m_live, n, \
             n_pad, k, exclude_self, out_d, out_i, rescored, st)
  cudaError_t err;
  if (k <= 1) err = KNN_LAUNCH(1);
  else if (k <= 2) err = KNN_LAUNCH(2);
  else if (k <= 4) err = KNN_LAUNCH(4);
  else if (k <= 8) err = KNN_LAUNCH(8);
  else if (k <= 16) err = KNN_LAUNCH(16);
  else if (k <= 32) err = KNN_LAUNCH(32);
  else if (k <= 64) err = KNN_LAUNCH(64);
  else if (k <= 128) err = KNN_LAUNCH(128);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef KNN_LAUNCH
  return static_cast<int>(err);
}
