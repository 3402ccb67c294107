// Tri-planar patch gather, hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel subcort_tpu/ops/pallas_gather.py::
// gather_triplanar_pallas (kernel body _gather_kernel). Both compute, for
// each center (s, x, y, z), three 32x32 windows of a volume zero-padded by
// 16 on every side: axial (x, y) at z, coronal (x, z) at y and sagittal
// (y, z) at x, each spanning [c - 16, c + 15] in original coordinates, i.e.
// starting at padded index c.
//
// What bounds it: bytes alone; a gather does no arithmetic. Each center
// writes 12 KB (3 x 32 x 32 float32) and reads at most as much; the least
// time is the distinct bytes the windows touch plus the bytes written, over
// the memory rate.
//
// What the design does about it:
// - Layouts (made once per volume by ops/gather_kernel.py::
//   prepare_gather_volume, outside this kernel): xyz (S, X', Y', Z'4) for
//   the coronal and sagittal windows and the z-major zxy (S, Z', X', Y'4)
//   for the axial one. In both, every window is 32 rows of 32 contiguous
//   floats, so no read fetches a sector for one value. Z'4 and Y'4 round
//   up to 4 floats: TMA takes only global strides that are multiples of
//   16 bytes.
// - Loads through the Tensor Memory Accelerator: one thread per block
//   issues, for each center, three cp.async.bulk.tensor loads from three
//   4-D tensor maps (a box shape belongs to its map: coronal and sagittal
//   read the same xyz memory through two maps) into one stage of a
//   shared-memory ring, completed on the stage's mbarrier. A tiled TMA load
//   must start its innermost coordinate on a 16-byte boundary (an H100
//   raises an illegal instruction otherwise), and a window starts anywhere,
//   so each box is 36 floats wide from the 4-float boundary at or below
//   the window's start.
// - The warp moves each box row's 32 window floats to the front of the box
//   (a shift of 0-3 floats; shared memory only), and one thread issues
//   three 4 KB cp.async.bulk stores of the windows into the (N, 32, 32)
//   outputs.
// - A persistent grid of kBlocksPerSm one-warp blocks per SM, each walking
//   contiguous chunks of centers with kStages - 1 centers' loads in
//   flight. The warp stages a chunk's center rows in shared memory first,
//   so the issuing thread never waits on a global load of its next center.
//
// Tensor map boxes, coordinates innermost first (S = 1 for one volume;
// a& = a rounded down to a multiple of 4):
//   axial    zxy box (y 36, x 32, z 1, s 1) at (cy&, cx, cz + 16, s)
//   coronal  xyz box (z 36, y 1, x 32, s 1) at (cz&, cy + 16, cx, s)
//   sagittal xyz box (z 36, y 32, x 1, s 1) at (cz&, cy, cx + 16, s)
// Each box lands in shared memory as 32 rows of 36 floats, the window's
// row-major rows at column cy - cy& (axial) or cz - cz&, so nothing is
// transposed. No swizzle, no interleave; the 4 floats past a window's end
// may leave the map and read as zeros (TMA's bounds fill). The rest of a
// box stays inside: the caller keeps centers inside the volume.
//
// History: the first version of this kernel read the padded volume in
// place, one 256-thread block per center, each value through a register.
// Its axial reads ran Z' floats apart, one 32-byte sector per 4-byte
// value (8x the useful bytes). It took 0.1466 ms on 8,192 random centers
// of the MNI volume (213 x 249 x 213 padded) and 0.0666 ms in situ on an
// H100 80GB HBM3 at 700 W, under half of its bound.

#include <cstdint>
#include <cstdio>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kHalf = kPatch / 2;
constexpr int kWindowFloats = kPatch * kPatch;
constexpr uint32_t kWindowBytes = kWindowFloats * 4;   // 4 KB
// box rows start on a 4-float (16-byte) boundary and are 36 floats wide
constexpr int kAlign = 4;
constexpr int kBoxRow = kPatch + kAlign;                // 36 floats
constexpr uint32_t kBoxBytes = kPatch * kBoxRow * 4;    // 4,608 bytes
constexpr uint32_t kStageBytes = 3 * kBoxBytes;         // one center
constexpr int kStages = 5;
constexpr int kMaxChunk = 256;                          // center rows staged
constexpr int kBlocksPerSm = 3;
constexpr int kThreads = 32;
// 128 bytes of slack to align the ring, the ring, the rows, the barriers
constexpr int kSmemBytes =
    128 + kStages * kStageBytes + kMaxChunk * 16 + kStages * 8;
static_assert(kBoxBytes % 128 == 0, "TMA boxes land 128-byte aligned");

// errors that are not a cudaError_t
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until the barrier's phase of parity `parity` has completed. A
// transaction that never arrives (a bad tensor map) traps after
// kWaitLimitNs, so the launch fails instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) {
      return;
    }
    if (start == 0) {
      start = now_ns();
    } else if (now_ns() - start > kWaitLimitNs) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Every committed store group but the newest `kPending` has finished
// reading shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kPending)
               : "memory");
}

// The generic proxy's shared-memory accesses before it are ordered with
// the async proxy's (TMA, bulk copies) after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ int floor_align(int v) {
  return v & ~(kAlign - 1);
}

// Arms `bar` for one center's three boxes and issues their loads into the
// stage at shared address `stage`: axial, coronal, sagittal, kBoxBytes
// apart. c = (s, x, y, z).
__device__ __forceinline__ void load_center(const CUtensorMap* axial_map,
                                            const CUtensorMap* coronal_map,
                                            const CUtensorMap* sagittal_map,
                                            uint32_t stage, uint32_t bar,
                                            int4 c) {
  const int s = c.x, x = c.y, y = c.z, z = c.w;
  mbar_expect_tx(bar, kStageBytes);
  tma_load_4d(stage, axial_map, bar, floor_align(y), x, z + kHalf, s);
  tma_load_4d(stage + kBoxBytes, coronal_map, bar, floor_align(z),
              y + kHalf, x, s);
  tma_load_4d(stage + 2 * kBoxBytes, sagittal_map, bar, floor_align(z), y,
              x + kHalf, s);
}

// Moves the window's 32 floats of each 36-float box row, which start
// `shift` floats in, to the front of the box as a row-major 32x32 window.
// Row r's destination never reaches a later row's source (32 r + 32 <=
// 36 (r + 1)); within a row the whole warp reads before any lane writes.
__device__ __forceinline__ void compact_window(float* box, int shift,
                                               int lane) {
  float v[kPatch];
#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    v[r] = box[r * kBoxRow + shift + lane];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    box[r * kPatch + lane] = v[r];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_triplanar_tma(const __grid_constant__ CUtensorMap axial_map,
                     const __grid_constant__ CUtensorMap coronal_map,
                     const __grid_constant__ CUtensorMap sagittal_map,
                     const int32_t* __restrict__ centers, int center_cols,
                     int64_t n, int chunk, float* __restrict__ axial,
                     float* __restrict__ coronal,
                     float* __restrict__ sagittal) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t pad = ((raw + 127u) & ~127u) - raw;  // TMA: 128-byte boxes
  const uint32_t ring = raw + pad;
  float* ring_ptr = reinterpret_cast<float*>(smem + pad);
  // the ring, then the center rows (16-byte aligned), then the barriers
  int4* rows = reinterpret_cast<int4*>(smem + pad + kStages * kStageBytes);
  const uint32_t bars = ring + kStages * kStageBytes + kMaxChunk * 16;
  const int lane = threadIdx.x;

  if (lane == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(bars + 8 * k, 1);
    }
    // the barriers were written by the generic proxy; the TMA unit
    // (async proxy) completes them
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    fence_proxy_async();
  }

  uint32_t used = 0;  // centers this block has consumed
  const int64_t step = static_cast<int64_t>(gridDim.x) * chunk;
  for (int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk; c0 < n;
       c0 += step) {
    const int m = static_cast<int>(n - c0 < chunk ? n - c0 : chunk);
    __syncwarp();  // every lane is done with the previous chunk's rows
    for (int k = lane; k < m; k += kThreads) {
      const int32_t* r = centers + (c0 + k) * center_cols;
      rows[k] = make_int4(center_cols == 4 ? r[0] : 0, r[center_cols - 3],
                          r[center_cols - 2], r[center_cols - 1]);
    }
    __syncwarp();
    const int ahead = m < kStages - 1 ? m : kStages - 1;
    if (lane == 0) {
      // the previous chunk's stores have read every stage
      bulk_wait_read<0>();
      for (int k = 0; k < ahead; ++k) {
        const uint32_t slot = (used + k) % kStages;
        load_center(&axial_map, &coronal_map, &sagittal_map,
                    ring + slot * kStageBytes, bars + 8 * slot, rows[k]);
      }
    }
    for (int k = 0; k < m; ++k) {
      const uint32_t slot = (used + k) % kStages;
      const uint32_t stage = ring + slot * kStageBytes;
      float* box = ring_ptr + slot * (kStageBytes / 4);
      const int4 c = rows[k];
      mbar_wait(bars + 8 * slot, ((used + k) / kStages) & 1u);
      compact_window(box, c.z & (kAlign - 1), lane);
      compact_window(box + kBoxBytes / 4, c.w & (kAlign - 1), lane);
      compact_window(box + 2 * kBoxBytes / 4, c.w & (kAlign - 1), lane);
      fence_proxy_async();  // the compacted windows, for the bulk stores
      __syncwarp();
      if (lane == 0) {
        const int64_t out = (c0 + k) * kWindowFloats;
        bulk_store(axial + out, stage, kWindowBytes);
        bulk_store(coronal + out, stage + kBoxBytes, kWindowBytes);
        bulk_store(sagittal + out, stage + 2 * kBoxBytes, kWindowBytes);
        bulk_commit();
        const int next = k + kStages - 1;
        if (next < m) {
          // next's slot held center k - 1: its stores are all but the
          // newest group, and the warp's reads of it came before the
          // fence above
          bulk_wait_read<1>();
          const uint32_t nslot = (used + next) % kStages;
          load_center(&axial_map, &coronal_map, &sagittal_map,
                      ring + nslot * kStageBytes, bars + 8 * nslot,
                      rows[next]);
        }
      }
    }
    used += m;
  }
  if (lane == 0) {
    // the ring must outlive the stores that read it
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API through the runtime's
// entry-point query, so the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D float32 map over `base` with extents `dims` and byte strides
// `strides` of dims 1..3, innermost first; returns 0 or an error code.
int encode(EncodeTiled fn, CUtensorMap* map, const float* base,
           const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
           const cuuint32_t (&box)[4]) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          const_cast<float*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_NONE,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncodeBase - static_cast<int>(res);
}

}  // namespace

// xyz: (s, xp, yp, z4) and zxy: (s, zp, xp, y4) float32, contiguous, on
// the current device, with y4 / z4 the extents yp / zp rounded up to a
// multiple of 4. centers: (n, center_cols) int32, contiguous; center_cols
// 3 = (x, y, z) with s = 1, 4 = (s, x, y, z). Outputs: three (n, 32, 32)
// float32, 16-byte aligned. Launches on `stream`; returns 0, a
// cudaError_t, or a negative code for gather_triplanar_error_string.
extern "C" int gather_triplanar_f32(const float* xyz, const float* zxy,
                                    int64_t s, int64_t xp, int64_t yp,
                                    int64_t zp, int64_t y4, int64_t z4,
                                    const int32_t* centers, int center_cols,
                                    int64_t n, float* axial, float* coronal,
                                    float* sagittal, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) {
    return kErrNoEncoder;
  }
  const cuuint64_t f = sizeof(float);
  CUtensorMap axial_map, coronal_map, sagittal_map;
  const cuuint64_t xyz_dims[4] = {static_cast<cuuint64_t>(zp),
                                  static_cast<cuuint64_t>(yp),
                                  static_cast<cuuint64_t>(xp),
                                  static_cast<cuuint64_t>(s)};
  const cuuint64_t xyz_strides[3] = {z4 * f, yp * z4 * f, xp * yp * z4 * f};
  const cuuint64_t zxy_dims[4] = {static_cast<cuuint64_t>(yp),
                                  static_cast<cuuint64_t>(xp),
                                  static_cast<cuuint64_t>(zp),
                                  static_cast<cuuint64_t>(s)};
  const cuuint64_t zxy_strides[3] = {y4 * f, xp * y4 * f, zp * xp * y4 * f};
  const cuuint32_t coronal_box[4] = {kBoxRow, 1, kPatch, 1};
  const cuuint32_t plane_box[4] = {kBoxRow, kPatch, 1, 1};
  int err = encode(fn, &axial_map, zxy, zxy_dims, zxy_strides, plane_box);
  if (err == 0) {
    err = encode(fn, &coronal_map, xyz, xyz_dims, xyz_strides, coronal_box);
  }
  if (err == 0) {
    err = encode(fn, &sagittal_map, xyz, xyz_dims, xyz_strides, plane_box);
  }
  if (err != 0) {
    return err;
  }

  int device = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess) {
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  }
  if (cerr == cudaSuccess) {
    cerr = cudaFuncSetAttribute(gather_triplanar_tma,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  }
  if (cerr != cudaSuccess) {
    return static_cast<int>(cerr);
  }
  const int64_t max_blocks = static_cast<int64_t>(kBlocksPerSm) * sms;
  int64_t chunk = (n + max_blocks - 1) / max_blocks;
  chunk = chunk < 1 ? 1 : (chunk > kMaxChunk ? kMaxChunk : chunk);
  int64_t blocks = (n + chunk - 1) / chunk;
  blocks = blocks < max_blocks ? blocks : max_blocks;
  gather_triplanar_tma<<<static_cast<unsigned int>(blocks), kThreads,
                         kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      axial_map, coronal_map, sagittal_map, centers, center_cols, n,
      static_cast<int>(chunk), axial, coronal, sagittal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_triplanar_error_string(int code) {
  if (code == kErrNoEncoder) {
    return "cuTensorMapEncodeTiled is not available from the CUDA driver API";
  }
  if (code <= kErrEncodeBase) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             kErrEncodeBase - code);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
