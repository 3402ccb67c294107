// Tri-planar patch gather, hand-written for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel subcort_tpu/ops/pallas_gather.py::
// gather_triplanar_pallas (kernel body _gather_kernel). Both compute, for
// each center (s, x, y, z), three 32x32 windows of a volume zero-padded by
// 16 on every side: axial (x, y) at z, coronal (x, z) at y and sagittal
// (y, z) at x, each spanning [c - 16, c + 15] in original coordinates, i.e.
// starting at padded index c.
//
// The TPU kernel copied a tile-aligned (40, 256) superblock per (patch,
// view) from three transposed, alignment-padded copies of the volume into
// VMEM and rolled the window into place, because Mosaic DMAs must start on
// (8, 128) tile boundaries. None of that carries over: this kernel reads
// the one padded volume (S, X', Y', Z') in place, with no transposed copies
// and no alignment pads, and lets the L2 cache hold the planes that
// neighbouring centers share.
//
// What bounds it: pure bytes, no arithmetic. Each center writes 12 KB
// (3 x 32 x 32 float32). Coronal and sagittal windows are 32 rows that are
// contiguous in z (one 128-byte line each), so a warp's loads coalesce.
// Axial windows run along y at fixed z, so a warp reads 32 values Z' floats
// apart: one 32-byte sector per value, 8x the useful bytes. A later change
// can stage the axial (x, y) slab through shared memory or read it from a
// z-major copy; the stores are already coalesced for all three views.
//
// Layout of the launch: one block of 256 threads per center; thread t
// writes elements t, t + 256, t + 512, t + 768 of each of the three
// outputs, so consecutive threads store to consecutive addresses. Offsets
// are computed in 64-bit. Centers must lie inside the original volume
// (the caller checks that); the kernel does not clamp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kHalf = kPatch / 2;
constexpr int kPatchElems = kPatch * kPatch;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_triplanar_kernel(const float* __restrict__ vol,
                        const int32_t* __restrict__ centers, int center_cols,
                        int64_t xp, int64_t yp, int64_t zp,
                        float* __restrict__ axial,
                        float* __restrict__ coronal,
                        float* __restrict__ sagittal) {
  const int64_t n = blockIdx.x;
  const int32_t* row = centers + n * center_cols;
  const int64_t s = center_cols == 4 ? row[0] : 0;
  const int64_t cx = row[center_cols - 3];
  const int64_t cy = row[center_cols - 2];
  const int64_t cz = row[center_cols - 1];
  const float* v = vol + s * xp * yp * zp;
  const int64_t out = n * kPatchElems;
#pragma unroll
  for (int k = 0; k < kPatchElems / kThreads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int64_t i = e / kPatch;
    const int64_t j = e % kPatch;
    axial[out + e] = v[((cx + i) * yp + (cy + j)) * zp + (cz + kHalf)];
    coronal[out + e] = v[((cx + i) * yp + (cy + kHalf)) * zp + (cz + j)];
    sagittal[out + e] = v[((cx + kHalf) * yp + (cy + i)) * zp + (cz + j)];
  }
}

}  // namespace

// vol: (S, xp, yp, zp) float32, contiguous, on the device.
// centers: (n, center_cols) int32, contiguous; center_cols 3 = (x, y, z)
// with S = 1, 4 = (s, x, y, z). Outputs: three (n, 32, 32) float32.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int gather_triplanar_f32(const float* vol, const int32_t* centers,
                                    int center_cols, int64_t n, int64_t xp,
                                    int64_t yp, int64_t zp, float* axial,
                                    float* coronal, float* sagittal,
                                    void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  gather_triplanar_kernel<<<static_cast<unsigned int>(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      vol, centers, center_cols, xp, yp, zp, axial, coronal, sagittal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_triplanar_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
