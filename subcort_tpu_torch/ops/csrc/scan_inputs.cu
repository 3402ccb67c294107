// The dense scan's inputs derived on the card, hand-written for NVIDIA
// Hopper (sm_90a): the scan's nonzero moments and the candidates' extent
// (scan_moments), and the candidates' prior rows and linear bbox indices
// (prior_rows).
//
// Replaces no TPU kernel: the JAX package computes these on its host in
// numpy (subcort_tpu/ops/normalize.py::normalize_stats, subcort_tpu/engine/
// infer.py::_bbox_of, ::_fcn_slab_inputs, ::_atlas_vectors_host,
// ::_quantize_priors), and so did the port, which left the card idle while
// it did. subcort_tpu_torch/ops/scan_inputs.py holds the plain versions of
// both kernels and says what each computes.
//
// scan_moments, on a narrow-integer scan of n voxels (int8, uint8, int16 or
// uint16) and (rows, 3) int32 centers: out[0..2] = the count of nonzero
// voxels, the sum and the sum of squares, in int64; out[3..5] the centers'
// per-axis minimum and out[6..8] their maximum. Integer sums are exact, so
// the host's float64 statistics follow bit for bit while the sum of
// squares stays below 2**53. What bounds it: bytes, each voxel and center
// read once (14.2 MB and 2.45 MB at MNI size, about 5 us at 3.35 TB/s), and
// at that size the launch. The design: 16-byte loads, per-thread int64
// sums, a warp-shuffle and shared-memory reduction, then one 64-bit atomic
// per block and value into out, which a one-block launch has set to the
// identities first.
//
// prior_rows, on a (bx, by, bz, 15) float32 prior block (the candidates'
// bbox cut from the atlas) and the bbox origin lo: one group of 16 lanes a
// row, in the caller's order, duplicates kept. A row is a candidate's
// voxel (centers given; its linear bbox index (x * by + y) * bz + z goes to
// lin as int64) or, without centers, block voxel i in C order. The group
// reads the row's 15 priors (60 contiguous bytes), each lane gathers all 15
// by shuffles and sums them in numpy's float32 order (pairwise over the
// first 8, then the other 7 one by one), so that the background fix-up
// (a row that sums to 0 becomes channel 14 = 1, the rest 0) decides as the
// host does; lane c then writes channel c in the wire type: uint8 and
// uint16 as round-half-even fixed point (x * 255, x * 65535, then as numpy
// casts: to int32, INT32_MIN out of range, the low bits kept), float16
// rounded to nearest, float32 as is. What bounds it: bytes, 60 B read and
// 30 B (uint16) plus 8 B of index written a row, about 22 MB or 7 us at MNI
// size (204,403 rows), and at that size the launch.

#include <climits>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kChannels = 15;
constexpr int kGroup = 16;   // lanes a row in prior_rows
constexpr int kMoments = 9;
constexpr int kErrBadArgs = -1;

// the voxel types, as ops/scan_inputs.py numbers them
enum VoxelType { kInt8 = 0, kUint8 = 1, kInt16 = 2, kUint16 = 3 };
// the wire types of the prior rows
enum RowType { kRowUint8 = 0, kRowUint16 = 1, kRowFloat16 = 2,
               kRowFloat32 = 3 };

__global__ void moments_init(long long* out) {
  const int i = threadIdx.x;
  if (i < 3) {
    out[i] = 0;
  } else if (i < 6) {
    out[i] = LLONG_MAX;
  } else if (i < kMoments) {
    out[i] = LLONG_MIN;
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ long long lesser(long long a, long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ long long greater(long long a, long long b) {
  return b > a ? b : a;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = lesser(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = greater(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_moments(const T* __restrict__ vol, long long n,
                 const int32_t* __restrict__ centers, long long rows,
                 long long* __restrict__ out) {
  constexpr int kPerLoad = 16 / sizeof(T);
  long long count = 0, sum = 0, squares = 0;
  long long lo[3] = {LLONG_MAX, LLONG_MAX, LLONG_MAX};
  long long hi[3] = {LLONG_MIN, LLONG_MIN, LLONG_MIN};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // 16-byte loads where the volume is 16-byte aligned (torch's allocations
  // are), one element at a time for the tail or an unaligned volume
  const bool aligned = (reinterpret_cast<uintptr_t>(vol) & 15) == 0;
  const long long loads = aligned ? n / kPerLoad : 0;
  const uint4* vec = reinterpret_cast<const uint4*>(vol);
  for (long long i = tid; i < loads; i += stride) {
    const uint4 q = vec[i];
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int k = 0; k < kPerLoad; ++k) {
      const long long x = e[k];
      count += x != 0;
      sum += x;
      squares += x * x;
    }
  }
  for (long long i = loads * kPerLoad + tid; i < n; i += stride) {
    const long long x = vol[i];
    count += x != 0;
    sum += x;
    squares += x * x;
  }
  for (long long r = tid; r < rows; r += stride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const long long c = centers[3 * r + k];
      lo[k] = lesser(lo[k], c);
      hi[k] = greater(hi[k], c);
    }
  }
  long long v[kMoments] = {warp_sum(count), warp_sum(sum), warp_sum(squares),
                           warp_min(lo[0]), warp_min(lo[1]), warp_min(lo[2]),
                           warp_max(hi[0]), warp_max(hi[1]), warp_max(hi[2])};
  __shared__ long long partial[kMoments][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kMoments; ++m) {
      partial[m][warp] = v[m];
    }
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    const int m = threadIdx.x;
    long long acc = partial[m][0];
    for (int w = 1; w < kWarps; ++w) {
      const long long p = partial[m][w];
      acc = m < 3 ? acc + p : (m < 6 ? lesser(acc, p) : greater(acc, p));
    }
    if (m < 3) {
      // two's complement: an unsigned add is the signed one
      atomicAdd(reinterpret_cast<unsigned long long*>(out + m),
                static_cast<unsigned long long>(acc));
    } else if (m < 6) {
      atomicMin(out + m, acc);
    } else {
      atomicMax(out + m, acc);
    }
  }
}

// numpy's float32 -> narrow unsigned cast: through int32 (INT32_MIN where
// the value is out of int32's range or NaN, as x86's cvttss2si gives),
// keeping the low bits
__device__ __forceinline__ uint32_t as_numpy_int(float f) {
  const int32_t i = (f >= -2147483648.0f && f < 2147483648.0f)
                        ? static_cast<int32_t>(f)
                        : INT32_MIN;
  return static_cast<uint32_t>(i);
}

template <int kRow>
struct Wire;

template <>
struct Wire<kRowUint8> {
  using type = uint8_t;
  __device__ static type put(float x) {
    return static_cast<uint8_t>(as_numpy_int(rintf(__fmul_rn(x, 255.0f))));
  }
};

template <>
struct Wire<kRowUint16> {
  using type = uint16_t;
  __device__ static type put(float x) {
    return static_cast<uint16_t>(
        as_numpy_int(rintf(__fmul_rn(x, 65535.0f))));
  }
};

template <>
struct Wire<kRowFloat16> {
  using type = __half;
  __device__ static type put(float x) { return __float2half_rn(x); }
};

template <>
struct Wire<kRowFloat32> {
  using type = float;
  __device__ static type put(float x) { return x; }
};

template <int kRow>
__global__ void __launch_bounds__(kThreads)
    prior_rows(const float* __restrict__ block, int by, int bz,
               const int32_t* __restrict__ centers, long long rows, int lox,
               int loy, int loz, typename Wire<kRow>::type* __restrict__ out,
               long long* __restrict__ lin) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kGroup;
  const int lane = threadIdx.x % kGroup;
  // a group's 16 lanes: one half of the warp
  const unsigned group = 0xffffu << (threadIdx.x & kGroup);
  if (row >= rows) {
    return;  // the whole group: row is the same on its lanes
  }
  long long voxel = row;
  if (centers != nullptr) {
    const long long x = centers[3 * row] - lox;
    const long long y = centers[3 * row + 1] - loy;
    const long long z = centers[3 * row + 2] - loz;
    voxel = (x * by + y) * bz + z;
    if (lane == 0) {
      lin[row] = voxel;
    }
  }
  float mine = lane < kChannels ? block[voxel * kChannels + lane] : 0.0f;
  float p[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    p[c] = __shfl_sync(group, mine, c, kGroup);
  }
  // numpy's float32 sum of 15: pairwise over 8, then the rest in order
  float s = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                      __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
#pragma unroll
  for (int c = 8; c < kChannels; ++c) {
    s = __fadd_rn(s, p[c]);
  }
  if (s == 0.0f) {
    mine = lane == kChannels - 1 ? 1.0f : 0.0f;
  }
  if (lane < kChannels) {
    out[row * kChannels + lane] = Wire<kRow>::put(mine);
  }
}

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return static_cast<int>(err);
}

template <typename T>
int launch_moments(const void* vol, long long n, const int32_t* centers,
                   long long rows, long long* out, cudaStream_t s) {
  int sms = 0;
  if (int err = sm_count(&sms)) {
    return err;
  }
  const long long loads = n / static_cast<long long>(16 / sizeof(T)) + 1;
  const long long work = loads > rows ? loads : rows;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < most ? want : most);
  moments_init<<<1, 32, 0, s>>>(out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  scan_moments<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(vol), n,
                                               centers, rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kRow>
int launch_rows(const float* block, int by, int bz, const int32_t* centers,
                long long rows, int lox, int loy, int loz, void* out,
                long long* lin, cudaStream_t s) {
  const long long blocks = (rows * kGroup + kThreads - 1) / kThreads;
  prior_rows<kRow><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      block, by, bz, centers, rows, lox, loy, loz,
      static_cast<typename Wire<kRow>::type*>(out), lin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int scan_moments_launch(const void* vol, int voxel_type,
                                   int64_t n, const int32_t* centers,
                                   int64_t rows, long long* out,
                                   void* stream) {
  // below 2**31 voxels of at most 16 bits the sums fit int64
  if (n < 0 || rows < 0 || n >= (int64_t{1} << 31) ||
      rows >= (int64_t{1} << 31)) {
    return kErrBadArgs;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (voxel_type) {
    case kInt8:
      return launch_moments<int8_t>(vol, n, centers, rows, out, s);
    case kUint8:
      return launch_moments<uint8_t>(vol, n, centers, rows, out, s);
    case kInt16:
      return launch_moments<int16_t>(vol, n, centers, rows, out, s);
    case kUint16:
      return launch_moments<uint16_t>(vol, n, centers, rows, out, s);
    default:
      return kErrBadArgs;
  }
}

extern "C" int prior_rows_launch(const float* block, int64_t bx, int64_t by,
                                 int64_t bz, const int32_t* centers,
                                 int64_t rows, int64_t lox, int64_t loy,
                                 int64_t loz, int row_type, void* out,
                                 long long* lin, void* stream) {
  if (bx <= 0 || by <= 0 || bz <= 0 || rows < 0 ||
      bx * by * bz >= (int64_t{1} << 31) || rows >= (int64_t{1} << 31) ||
      (centers == nullptr && rows != bx * by * bz) ||
      (centers != nullptr && lin == nullptr)) {
    return kErrBadArgs;
  }
  if (rows == 0) {
    return 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int y = static_cast<int>(by), z = static_cast<int>(bz);
  const int ox = static_cast<int>(lox), oy = static_cast<int>(loy),
            oz = static_cast<int>(loz);
  switch (row_type) {
    case kRowUint8:
      return launch_rows<kRowUint8>(block, y, z, centers, rows, ox, oy, oz,
                                    out, lin, s);
    case kRowUint16:
      return launch_rows<kRowUint16>(block, y, z, centers, rows, ox, oy, oz,
                                     out, lin, s);
    case kRowFloat16:
      return launch_rows<kRowFloat16>(block, y, z, centers, rows, ox, oy, oz,
                                      out, lin, s);
    case kRowFloat32:
      return launch_rows<kRowFloat32>(block, y, z, centers, rows, ox, oy, oz,
                                      out, lin, s);
    default:
      return kErrBadArgs;
  }
}

extern "C" const char* scan_inputs_error_string(int code) {
  if (code == kErrBadArgs) {
    return "bad arguments: a voxel or row type the kernels do not take, an "
           "empty or oversized block, or rows that do not match the block";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
