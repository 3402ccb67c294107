// The tri-planar net's inference batch norm and PReLU in one pass,
// hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these elementwise ops to
// XLA, which fuses them into its convolutions' epilogues. The port ran them
// as four ATen passes (subtract, multiply, add, PReLU), each a read and a
// write of every value out of every convolution of every branch.
// subcort_tpu_torch/ops/bn_prelu.py binds this file and checks its
// arguments; models/triplanar.py::_Branch.bn_prelu says when it is taken.
//
// On an NCHW tensor x of n values, float32 or bfloat16, channels C of hw
// values each, for each value x of channel c:
//
//   s   = inv_std[c] * gamma[c]
//   y   = (x - mean[c]) * s + beta[c]
//   out = y > 0 ? y : alpha[c] * y
//
// as the ATen ops it replaces compute them: each operation in float32,
// rounded to nearest on its own (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
// contraction), then, for bfloat16, rounded to bfloat16 by the same
// conversion ATen's bfloat16 type makes on this card (__float2bfloat16_rn),
// in the order of the ops. Built without fast math, so denormals are kept:
// the output equals theirs bit for bit, infinities, NaN and -0.0 included.
//
// What bounds it: bytes, one read and one write a value (the patch engine's
// conv1 output in float32, 8,192 x 20 x 30 x 30 values, 1.18 GB: 0.352 ms
// at 3.35 TB/s). The design: the block first puts each channel's (mean, s,
// beta, alpha) into shared memory as one float4 (16 B a channel; past the
// default 48 KiB the launch opts into more, up to kMaxChannels), then a
// grid-stride loop over the values, a full wave of blocks at 8 a streaming
// multiprocessor. Where x and out are aligned to four values each thread
// takes 4 values a step with one load and one store (16 B in float32, 8 B
// in bfloat16), on any hw: it divides once for the first value's plane and
// channel and steps along the plane for the other three, so an odd plane
// (every dense slab's, the patch engine's 3 x 3 conv5) takes the vector
// path too; the last n % 4 values, or every value where a pointer is not
// aligned, one at a time. Indices are 32-bit: n < 2**31 a launch (the
// wrapper splits a larger tensor between samples). No allocation, no host
// sync: safe inside a CUDA graph capture.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads an SM: a full wave
constexpr int64_t kDefaultShared = 48 * 1024;
constexpr int64_t kMaxChannels = 14336;  // 224 KiB of float4 tables
constexpr int kErrBadArgs = -1;

// the element types, numbered as ops/bn_prelu.py numbers them
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// a float32 result as the element type holds it, back in float32
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// four values at once (16 B of float32, 8 B of bfloat16), as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// the values are already rounded to the element type: the stores are exact
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
struct Tables {
  const T* mean;
  const T* inv_std;
  const T* gamma;
  const T* beta;
  const T* alpha;
};

template <typename T>
__device__ __forceinline__ float4 channel_of(const Tables<T>& t, unsigned c) {
  const float s = rounded(
      __fmul_rn(static_cast<float>(t.inv_std[c]),
                static_cast<float>(t.gamma[c])), T());
  return make_float4(static_cast<float>(t.mean[c]), s,
                     static_cast<float>(t.beta[c]),
                     static_cast<float>(t.alpha[c]));
}

template <typename T>
__device__ __forceinline__ float bn_prelu_one(float x, float4 t) {
  const float d = rounded(__fsub_rn(x, t.x), T());
  const float p = rounded(__fmul_rn(d, t.y), T());
  const float y = rounded(__fadd_rn(p, t.z), T());
  return y > 0.0f ? y : rounded(__fmul_rn(t.w, y), T());
}

// one step along the plane; past its end, the next plane's channel
__device__ __forceinline__ void step(unsigned& r, unsigned& c, unsigned hw,
                                     unsigned channels) {
  if (++r == hw) {
    r = 0;
    if (++c == channels) {
      c = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_prelu(const T* __restrict__ x, T* __restrict__ out, unsigned n,
             unsigned hw, unsigned channels, Tables<T> t, bool vector) {
  extern __shared__ float4 table[];
  for (unsigned c = threadIdx.x; c < channels; c += blockDim.x) {
    table[c] = channel_of(t, c);
  }
  __syncthreads();
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned quads = vector ? n / 4 : 0;
  for (unsigned i = tid; i < quads; i += stride) {
    const float4 v = load4(x + 4 * i);
    const unsigned plane = 4 * i / hw;
    unsigned r = 4 * i - plane * hw, c = plane % channels;
    float4 w;
    w.x = bn_prelu_one<T>(v.x, table[c]);
    step(r, c, hw, channels);
    w.y = bn_prelu_one<T>(v.y, table[c]);
    step(r, c, hw, channels);
    w.z = bn_prelu_one<T>(v.z, table[c]);
    step(r, c, hw, channels);
    w.w = bn_prelu_one<T>(v.w, table[c]);
    store4(out + 4 * i, w);
  }
  for (unsigned e = 4 * quads + tid; e < n; e += stride) {
    out[e] = static_cast<T>(bn_prelu_one<T>(static_cast<float>(x[e]),
                                            table[e / hw % channels]));
  }
}

template <typename T>
int launch(const void* x, void* out, int64_t n, int64_t hw, int64_t channels,
           const void* const* tables, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  const int64_t shared = channels * static_cast<int64_t>(sizeof(float4));
  if (err == cudaSuccess && shared > kDefaultShared) {
    err = cudaFuncSetAttribute(bn_prelu<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const bool vector = ((reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(out)) %
                       (4 * sizeof(T))) == 0;
  const int64_t work = vector ? (n + 3) / 4 : n;
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < most ? want : most);
  const T* const* tt = reinterpret_cast<const T* const*>(tables);
  const Tables<T> t{tt[0], tt[1], tt[2], tt[3], tt[4]};
  bn_prelu<T><<<blocks, kThreads, static_cast<size_t>(shared), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<unsigned>(n), static_cast<unsigned>(hw),
      static_cast<unsigned>(channels), t, vector);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: mean, inv_std, gamma, beta, alpha, each C values of x's type
extern "C" int bn_prelu_launch(int dtype, const void* x, void* out,
                               int64_t n, int64_t hw, int64_t channels,
                               const void* const* tables, void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || hw <= 0 || channels <= 0 ||
      channels > kMaxChannels || (n > 0 && n % (hw * channels) != 0) ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return kErrBadArgs;
  }
  if (n == 0) {
    return 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32
             ? launch<float>(x, out, n, hw, channels, tables, s)
             : launch<__nv_bfloat16>(x, out, n, hw, channels, tables, s);
}

extern "C" const char* bn_prelu_error_string(int code) {
  if (code == kErrBadArgs) {
    return "bad arguments: 2**31 values or more, an empty plane, no "
           "channels or more than 14,336, a value count that is no "
           "multiple of a sample's, or a type neither float32 nor bfloat16";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
