// The DIPs trunks' dense-layer epilogue: eval-mode BatchNorm, then ReLU or
// the max-pool over a patch's points, in one pass over the activations.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm, ReLU and the
// max-pool after each dense layer of models/dips.py to XLA, which fuses
// them into the layer's output on the TPU, so there is no Pallas
// counterpart. The port's plain chain (models/dips.py::EvalBatchNorm.
// forward, then relu_ or amax) is four broadcast passes and a ReLU or a
// max pass, each reading (and most writing) the whole activation.
//
// What it computes, per element y of channel c, each step rounded to
// float32 in this order, as the plain chain does:
//   t = ((y - mean[c]) * scale[c]) * inv[c] + bias[c],
// with inv = rsqrt(var + eps) computed by PyTorch and passed in, so the
// factor is the same float. Then
//   bn_relu: isnan(t) ? t : fmaxf(t, 0) (torch.relu on the card: clamp_min
//            with NaN passed through), written back in place over a
//            (rows, C) activation;
//   bn_max:  (B, N, C) -> (B, C), the max of t over the N points, a NaN
//            winning as in torch.amax; the (B, N, C) result is never
//            written.
//
// What bounds it on the card: bytes. Five float32 operations per element
// against 8 bytes moved (in place) or 4 (max), far below the ~20
// operations per byte at which the card's float32 units would bound it.
// The least time is the activation read once (and written once) at the
// HBM rate.
//
// Design: one read and one write (bn_relu) or one read (bn_max) of the
// activation. A thread takes 4 channels with 16-byte loads and holds their
// four factors in registers for every row it visits; kUnroll loads are in
// flight before any is used.
//   bn_relu: blocks of (bx, by) threads, bx over the channel groups (all
//            of them up to 256), by over rows; a grid-stride loop over the
//            rows keeps each thread on its channel group. A warp reads
//            consecutive 16-byte words (bx = C/4 makes the rows of a block
//            one contiguous run).
//   bn_max:  one block per (patch, slab of up to 64 channel groups); the
//            by row groups of a block keep a running max in registers
//            over rows ty, ty + by, ..., then reduce through shared memory.
//            Loads are coalesced along C.
// Arithmetic is compiled with -fmad=false, so (t * inv) + bias is not
// fused and each operation rounds on its own, as in PyTorch's passes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kUnroll = 4;     // 16-byte loads in flight per thread
constexpr int kSlab = 64;      // channel groups per bn_max block

struct Factors {
  float4 mean, scale, inv, bias;
};

__device__ __forceinline__ Factors load_factors(const float4* __restrict__ mean,
                                                const float4* __restrict__ scale,
                                                const float4* __restrict__ inv,
                                                const float4* __restrict__ bias, int g) {
  return Factors{mean[g], scale[g], inv[g], bias[g]};
}

__device__ __forceinline__ float bn(float y, float m, float s, float i, float b) {
  float t = y - m;
  t = t * s;
  t = t * i;
  return t + b;
}

__device__ __forceinline__ float4 bn4(float4 v, const Factors& f) {
  return make_float4(bn(v.x, f.mean.x, f.scale.x, f.inv.x, f.bias.x),
                     bn(v.y, f.mean.y, f.scale.y, f.inv.y, f.bias.y),
                     bn(v.z, f.mean.z, f.scale.z, f.inv.z, f.bias.z),
                     bn(v.w, f.mean.w, f.scale.w, f.inv.w, f.bias.w));
}

// torch.relu on the card: clamp_min(t, 0), a NaN passed through.
__device__ __forceinline__ float relu(float t) { return isnan(t) ? t : fmaxf(t, 0.0f); }

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(relu(v.x), relu(v.y), relu(v.z), relu(v.w));
}

// One step of torch.amax on the card: a NaN wins, else the larger.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y), max_nan(a.z, b.z),
                     max_nan(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads) bn_relu_kernel(
    float4* __restrict__ x,  // (rows, groups), written in place
    const float4* __restrict__ mean, const float4* __restrict__ scale,
    const float4* __restrict__ inv, const float4* __restrict__ bias, long long rows,
    int groups) {
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const Factors f = load_factors(mean, scale, inv, bias, g);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y; r < rows;
       r += step * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      v[u] = ru < rows ? x[ru * groups + g] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + u * step;
      if (ru < rows) x[ru * groups + g] = relu4(bn4(v[u], f));
    }
  }
}

__global__ void __launch_bounds__(kThreads) bn_max_kernel(
    const float4* __restrict__ x,  // (batch, n, groups)
    const float4* __restrict__ mean, const float4* __restrict__ scale,
    const float4* __restrict__ inv, const float4* __restrict__ bias, int n, int groups,
    float4* __restrict__ out) {  // (batch, groups)
  extern __shared__ float4 part[];  // (blockDim.y, blockDim.x)
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int g = blockIdx.y * blockDim.x + tx;
  const long long b = blockIdx.x;
  float4 acc = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
  if (g < groups) {
    const Factors f = load_factors(mean, scale, inv, bias, g);
    const float4* src = x + b * n * groups + g;
    const int step = blockDim.y;
    int r = ty;
    for (; r + (kUnroll - 1) * step < n; r += kUnroll * step) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = src[static_cast<long long>(r + u * step) * groups];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = max4(acc, bn4(v[u], f));
    }
    for (; r < n; r += step) acc = max4(acc, bn4(src[static_cast<long long>(r) * groups], f));
  }
  part[ty * blockDim.x + tx] = acc;
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h /= 2) {
    if (ty < h) {
      part[ty * blockDim.x + tx] =
          max4(part[ty * blockDim.x + tx], part[(ty + h) * blockDim.x + tx]);
    }
    __syncthreads();
  }
  if (ty == 0 && g < groups) out[b * groups + g] = part[tx];
}

int sm_count() {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

extern "C" int dips_bn_relu_launch(void* x, const void* mean, const void* scale,
                                   const void* inv, const void* bias, long long rows,
                                   int channels, void* stream) {
  if (channels <= 0 || channels % 4 != 0 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int groups = channels / 4;
  const int bx = groups < kThreads ? groups : kThreads;
  const int by = kThreads / bx;
  const int gy = (groups + bx - 1) / bx;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = static_cast<long long>(by) * kUnroll;
  long long gx = (rows + per_block - 1) / per_block;
  // Two waves of whole SMs (2048 threads each) at most; the grid-stride
  // loop takes the rest, so a thread loads its factors once for many rows.
  long long cap = static_cast<long long>(sm_count()) * (2048 / (bx * by)) * 2 / gy;
  if (cap < 1) cap = 1;
  if (gx > cap) gx = cap;
  bn_relu_kernel<<<dim3(static_cast<unsigned>(gx), gy), dim3(bx, by), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(x), static_cast<const float4*>(mean),
      static_cast<const float4*>(scale), static_cast<const float4*>(inv),
      static_cast<const float4*>(bias), rows, groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dips_bn_max_launch(const void* x, const void* mean, const void* scale,
                                  const void* inv, const void* bias, long long batch, int n,
                                  int channels, void* out, void* stream) {
  if (channels <= 0 || channels % 4 != 0 || n <= 0 || batch < 0 || batch > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int groups = channels / 4;
  const int bx = groups < kSlab ? groups : kSlab;
  int width = 1;  // bx rounded up to a power of two
  while (width < bx) width *= 2;
  const int by = kThreads / width;  // a power of two, for the tree reduction
  const int gy = (groups + bx - 1) / bx;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = sizeof(float4) * bx * by;
  bn_max_kernel<<<dim3(static_cast<unsigned>(batch), gy), dim3(bx, by), shared,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(mean),
      static_cast<const float4*>(scale), static_cast<const float4*>(inv),
      static_cast<const float4*>(bias), n, groups, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
