// Per-class connected-component filter of a label map, hand-written for
// NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package labels components with scipy on
// the host (or with plain min-label propagation), and so did the port. This
// kernel sequence replaces the host's per-class loop of scipy's
// ndimage.label (the reference's cnn_cort/base.py:469), its bincounts and
// its argmax, for every class at once: subcort_tpu_torch/engine/
// postprocess.py::_filter_components computes the same function.
//
// What it computes, on a label crop (X, Y, Z) of uint8 classes (0 and any
// class >= num_classes are background) and a uint8 atlas mask of the same
// shape: for every class l, the 6-connected components of {labels == l};
// the winner of l is the component with the most voxels inside the atlas,
// or, when no component of l touches the atlas, the largest; ties go to the
// component whose first voxel comes first in raster order, which is how
// scipy numbers components and np.argmax breaks ties. The output keeps l on
// the winner's voxels and 0 elsewhere.
//
// What bounds it: bytes, and at the MNI crop (about 0.48 M voxels) the
// launches. Each voxel's label and atlas byte is read and its output byte
// written (3 B), and its 4-byte parent pointer is written by pass 1, read
// and rewritten by pass 3 and read by pass 5 (16 B): 19 B a voxel, about
// 9 MB or 3 us at 3.35 TB/s; the parents and counts of such a crop fit in
// the 50 MB L2. No arithmetic to speak of.
//
// What the design does about it: five launches on the caller's stream, no
// host synchronisation (the caller reads the output back once), and no
// pass that iterates to a fixpoint. Union-find with atomicMin linking makes
// every root its component's smallest linear index (a parent never exceeds
// its child, and the smallest voxel of a component can link to nothing
// smaller), so the root is the component's raster-order rank key and a
// winner is found by one 64-bit atomicMax of (count << 32) | ~root per
// class: the largest count, then the smallest root.
//   1. tile_merge: an 8x8x8 tile per block in shared memory; voxels of one
//      class merge with their -x, -y, -z neighbours inside the tile. Local
//      raster order agrees with global order inside a tile, so the local
//      root is the smallest voxel of the tile's part of the component; its
//      global index becomes the parent. Clears each voxel's count and the
//      class scores.
//   2. face_merge: voxels on a tile's low faces merge with the neighbour
//      across the face, in global memory.
//   3. count: each foreground voxel finds its root, writes it as its
//      parent, and adds (1 << 32) | atlas into the root's 64-bit count,
//      aggregated over the lanes of a warp that share a root.
//   4. score: each root offers (overlap << 32) | ~root and
//      (size << 32) | ~root to its class's two maxima, first in shared
//      memory, then one global atomicMax per class and block.
//   5. paint: out = l where the voxel's root is the winner of its class l.
// Classes never merge with each other, so one sequence serves every class.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr int kTileVoxels = kTile * kTile * kTile;   // 512 threads a block
constexpr int kThreads = 256;                        // the flat passes
constexpr int kMaxClasses = 256;                     // uint8 labels
constexpr int kScoreBlocksPerSm = 2;
constexpr int kErrBadArgs = -1;

struct Dims {
  int nx, ny, nz;
};

// class of a label byte: background where 0 or not a class
__device__ __forceinline__ int class_of(uint8_t v, int num_classes) {
  return v < num_classes ? v : 0;
}

// parents change under other threads' atomics: read them through volatile
__device__ __forceinline__ int find_root(const volatile int* parent, int i) {
  int p = parent[i];
  while (p != i) {
    i = p;
    p = parent[i];
  }
  return i;
}

// Join the trees of a and b: the larger root takes the smaller as its
// parent. An atomicMin that finds the root already re-linked by another
// thread goes on from that root's new parent.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) {
      return;
    }
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) {
      return;
    }
    b = old;
  }
}

__device__ __forceinline__ int linear(Dims d, int x, int y, int z) {
  return (x * d.ny + y) * d.nz + z;
}

// pass 1: threadIdx.x = (lx, ly, lz), z fastest; blockIdx = (z, y, x) tiles
__global__ void __launch_bounds__(kTileVoxels)
tile_merge(const uint8_t* labels, Dims d, int num_classes, int* parent,
           unsigned long long* counts, unsigned long long* best) {
  __shared__ int local[kTileVoxels];
  __shared__ uint8_t cls[kTileVoxels];
  const int t = threadIdx.x;
  const int x0 = blockIdx.z * kTile, y0 = blockIdx.y * kTile,
            z0 = blockIdx.x * kTile;
  const int lx = t / (kTile * kTile), ly = (t / kTile) % kTile,
            lz = t % kTile;
  const bool inside = x0 + lx < d.nx && y0 + ly < d.ny && z0 + lz < d.nz;
  const int g = inside ? linear(d, x0 + lx, y0 + ly, z0 + lz) : 0;
  int l = 0;
  if (inside) {
    l = class_of(labels[g], num_classes);
    counts[g] = 0ull;
  }
  cls[t] = static_cast<uint8_t>(l);
  local[t] = t;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      t < 2 * num_classes) {
    best[t] = 0ull;
  }
  __syncthreads();
  if (l != 0) {
    if (lz > 0 && cls[t - 1] == l) {
      unite(local, t - 1, t);
    }
    if (ly > 0 && cls[t - kTile] == l) {
      unite(local, t - kTile, t);
    }
    if (lx > 0 && cls[t - kTile * kTile] == l) {
      unite(local, t - kTile * kTile, t);
    }
  }
  __syncthreads();
  if (inside) {
    const int r = l != 0 ? find_root(local, t) : t;
    parent[g] = linear(d, x0 + r / (kTile * kTile), y0 + (r / kTile) % kTile,
                       z0 + r % kTile);
  }
}

// pass 2: the same grid; only voxels on a tile's low faces act
__global__ void __launch_bounds__(kTileVoxels)
face_merge(const uint8_t* labels, Dims d, int num_classes, int* parent) {
  const int t = threadIdx.x;
  const int lx = t / (kTile * kTile), ly = (t / kTile) % kTile,
            lz = t % kTile;
  if (lx != 0 && ly != 0 && lz != 0) {
    return;
  }
  const int x = blockIdx.z * kTile + lx, y = blockIdx.y * kTile + ly,
            z = blockIdx.x * kTile + lz;
  if (x >= d.nx || y >= d.ny || z >= d.nz) {
    return;
  }
  const int g = linear(d, x, y, z);
  const int l = class_of(labels[g], num_classes);
  if (l == 0) {
    return;
  }
  if (lz == 0 && z > 0 && class_of(labels[g - 1], num_classes) == l) {
    unite(parent, g - 1, g);
  }
  if (ly == 0 && y > 0 && class_of(labels[g - d.nz], num_classes) == l) {
    unite(parent, g - d.nz, g);
  }
  const int plane = d.ny * d.nz;
  if (lx == 0 && x > 0 && class_of(labels[g - plane], num_classes) == l) {
    unite(parent, g - plane, g);
  }
}

// pass 3: one thread a voxel; every lane of a warp reaches the votes
__global__ void __launch_bounds__(kThreads)
count(const uint8_t* labels, const uint8_t* atlas, int n, int num_classes,
      int* parent, unsigned long long* counts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int root = -1;
  bool in_atlas = false;
  if (i < n && class_of(labels[i], num_classes) != 0) {
    root = find_root(parent, i);
    parent[i] = root;
    in_atlas = atlas[i] != 0;
  }
  const unsigned atlas_lanes = __ballot_sync(0xffffffffu, in_atlas);
  const unsigned peers = __match_any_sync(0xffffffffu, root);
  if (root >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    const unsigned long long size = __popc(peers);
    const unsigned long long overlap = __popc(peers & atlas_lanes);
    atomicAdd(counts + root, (size << 32) | overlap);
  }
}

// pass 4: a grid-stride loop over the voxels; a block's maxima in shared
// memory first
__global__ void __launch_bounds__(kThreads)
score(const uint8_t* labels, int n, int num_classes, const int* parent,
      const unsigned long long* counts, unsigned long long* best) {
  __shared__ unsigned long long block_best[2 * kMaxClasses];
  for (int k = threadIdx.x; k < 2 * num_classes; k += kThreads) {
    block_best[k] = 0ull;
  }
  __syncthreads();
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int l = class_of(labels[i], num_classes);
    if (l == 0 || parent[i] != i) {
      continue;
    }
    const unsigned long long c = counts[i];
    const unsigned long long rank = static_cast<uint32_t>(~i);
    const unsigned long long by_overlap = (c << 32) | rank;
    const unsigned long long by_size = (c & 0xffffffff00000000ull) | rank;
    if (by_overlap > block_best[2 * l]) {
      atomicMax(block_best + 2 * l, by_overlap);
    }
    if (by_size > block_best[2 * l + 1]) {
      atomicMax(block_best + 2 * l + 1, by_size);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * num_classes; k += kThreads) {
    if (block_best[k] != 0ull) {
      atomicMax(best + k, block_best[k]);
    }
  }
}

// pass 5
__global__ void __launch_bounds__(kThreads)
paint(const uint8_t* labels, int n, int num_classes, const int* parent,
      const unsigned long long* best, uint8_t* out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) {
    return;
  }
  const int l = class_of(labels[i], num_classes);
  uint8_t v = 0;
  if (l != 0) {
    const unsigned long long by_overlap = best[2 * l];
    const unsigned long long w =
        (by_overlap >> 32) != 0ull ? by_overlap : best[2 * l + 1];
    if (parent[i] == static_cast<int>(~static_cast<uint32_t>(w))) {
      v = static_cast<uint8_t>(l);
    }
  }
  out[i] = v;
}

}  // namespace

// labels, atlas, out: (nx, ny, nz) contiguous uint8 on the device; scratch:
// parent int32[n], counts uint64[n], best uint64[2 * num_classes]. Returns
// 0, a CUDA error code (checked after every launch), or kErrBadArgs.
extern "C" int filter_components_u8(const uint8_t* labels,
                                    const uint8_t* atlas, int64_t nx,
                                    int64_t ny, int64_t nz, int num_classes,
                                    int32_t* parent,
                                    unsigned long long* counts,
                                    unsigned long long* best, uint8_t* out,
                                    void* stream) {
  const int64_t n = nx * ny * nz;
  if (nx <= 0 || ny <= 0 || nz <= 0 || n >= (int64_t{1} << 31) ||
      num_classes < 1 || num_classes > kMaxClasses) {
    return n == 0 ? 0 : kErrBadArgs;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d{static_cast<int>(nx), static_cast<int>(ny),
               static_cast<int>(nz)};
  const dim3 tiles((nz + kTile - 1) / kTile, (ny + kTile - 1) / kTile,
                   (nx + kTile - 1) / kTile);
  if (tiles.y > 65535 || tiles.z > 65535) {
    return kErrBadArgs;
  }
  const int flat = static_cast<int>((n + kThreads - 1) / kThreads);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = sms * kScoreBlocksPerSm;
  tile_merge<<<tiles, kTileVoxels, 0, s>>>(labels, d, num_classes, parent,
                                           counts, best);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  face_merge<<<tiles, kTileVoxels, 0, s>>>(labels, d, num_classes, parent);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  count<<<flat, kThreads, 0, s>>>(labels, atlas, static_cast<int>(n),
                                  num_classes, parent, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  score<<<flat < blocks ? flat : blocks, kThreads, 0, s>>>(
      labels, static_cast<int>(n), num_classes, parent, counts, best);
  if ((err = cudaGetLastError()) != cudaSuccess) {
    return static_cast<int>(err);
  }
  paint<<<flat, kThreads, 0, s>>>(labels, static_cast<int>(n), num_classes,
                                  parent, best, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* filter_components_error_string(int code) {
  if (code == kErrBadArgs) {
    return "bad arguments: empty or more than 2**31 - 1 voxels, a tile grid "
           "beyond 65535, or num_classes outside [1, 256]";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
