// Tri-plane sample forward with the coarse level resident in shared
// memory, on Hopper (sm_90a): kernel K3.
//
// K3 plane_sample_fwd_smem replaces the TPU kernel
// make_sample_quad_pallas_vmem (B2, myslam_tpu/ops/pallas_sample.py:82),
// which kept the whole quad atlas in VMEM and read rows by scalar index,
// together with its glue sample_fused_pallas (B3, :262) and the index
// math of plane_indices_and_fracs (:51).  It computes what B2 + B3
// compute, the forward of plane_sample.py::sample_fused: per point and
// level, the three planes' quad rows weighted in lane space by
// (0.5 + (wx-0.5)*sx) * (0.5 + (wy-0.5)*sy) and summed, (N, L*4C) f32.
// Layout and index math: see plane_common.cuh.
//
// What bounds it on an H100: bytes.  The (N, L*4C) f32 output is written
// once (164 MB at the 160,000-point mapping SDF sample, 0.050 ms at
// 3.35 TB/s); the quad and the points are small beside it, and there are
// ~4 flops per output element.
//
// What the residency does.  An H100 block may hold 227 KB of shared
// memory, not the TPU's whole-atlas VMEM, so only the coarse level (the
// 3 planes of level 0, the rows that most points share) is staged, once
// per block, with coalesced 16-byte loads.  Where it exceeds one block's
// budget, the kernel runs in thread-block clusters of up to 8 blocks:
// block r of a cluster holds rows [r*R, (r+1)*R) of the coarse level, and
// a coarse row is read from its owner's shared memory through the
// cluster's distributed shared memory (map_shared_rank).  The grid is
// persistent: as many whole clusters as can be resident at once (one
// block per SM: the coarse rows take its shared memory), so each cluster
// stages the coarse level once.
//
// The walk is K1's (fwd_walk in plane_common.cuh): a warp walks runs of
// `run` consecutive points, striding over the grid's warps; the index
// math runs once per (point, plane), one lane per point; the levels are
// unrolled, so all of a point's row loads issue together and the next
// point's before this point's streaming stores; a plane's row is loaded
// only where it differs from the one the warp holds.  Two differences:
// level 0's rows come from the cluster's shared memory (ClusterRows), and
// the tile's coordinates go to shared memory after the coarse rows only
// where those leave room (SmemTile; the synthetic room's 699 coarse rows
// do); where they fill it (Replica room0's 2,597 in 3-block clusters),
// the coordinates stay in the registers of the lane that computed them
// and reach the warp by shuffles (ShflTile), 4-6 % slower at the
// synthetic room's SDF sample where both fit (PERF.md).  The
// first design (a warp per point, every lane redoing the index math, a
// runtime level loop) was slower than K1 and stayed at 40 % of the
// bound.  With one block per SM, more warps come only from a larger
// block: SMEM_THREADS (512; 768 and 1,024 spilled registers and were
// slower), with a register budget that must not spill.

#include <cooperative_groups.h>

#include <type_traits>

#include "plane_common.cuh"

namespace cg = cooperative_groups;

// Threads of a block for the 1-2 levels of the port's layouts; 3-4 levels
// hold twice the rows and coordinates per lane, and take half as many
// threads, each with twice the registers.
#define SMEM_THREADS 512
#define SMEM_BLOCK(NL) ((NL) <= 2 ? SMEM_THREADS : SMEM_THREADS / 2)
#define MAX_CLUSTER 8

// Level 0's rows from the cluster's shared memory, finer levels' from
// device memory.
template <typename T>
struct ClusterRows {
  const T* __restrict__ quad;
  T* share;
  int c4, rows_per_block;
  __device__ __forceinline__ typename Row4<T>::V load(int k, int row,
                                                      int c) const {
    if (k < 3) {  // compile-time after unrolling
      const int owner = row / rows_per_block;
      const T* src = cg::this_cluster().map_shared_rank(share, owner) +
                     (size_t)(row - owner * rows_per_block) * c4 + c;
      return Row4<T>::load_generic(src);
    }
    return Row4<T>::load(quad + (size_t)row * c4 + c);
  }
};

// A tile's coordinates in shared memory: bytes of a block.
template <int NL>
constexpr size_t tile_bytes() {
  return (size_t)(SMEM_BLOCK(NL) / 32) * FWD_TILE * 3 * NL * sizeof(float4);
}

// kSmemTile: the tile's coordinates in shared memory after the coarse
// rows (where they leave room), else in registers.
template <typename T, int NL, bool kSmemTile>
__global__ void __launch_bounds__(SMEM_BLOCK(NL), 1)
plane_sample_fwd_smem_kernel(const float* __restrict__ p_nor,
                             const T* __restrict__ quad,
                             float* __restrict__ out, int n, int c4,
                             PlaneTable t, int coarse_rows,
                             int rows_per_block, int run) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* share = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  // Stage this block's share of the coarse rows, 16 bytes per load.
  const int first = rank * rows_per_block;
  const int count = max(0, min(rows_per_block, coarse_rows - first));
  const int vecs = count * (int)(c4 * sizeof(T) / 16);
  const uint4* src =
      reinterpret_cast<const uint4*>(quad + (size_t)first * c4);
  uint4* dst16 = reinterpret_cast<uint4*>(share);
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    dst16[i] = __ldg(src + i);
  // Every block's share is staged before any block reads a peer's.
  cluster.sync();

  typename std::conditional<kSmemTile, SmemTile<3 * NL>,
                            ShflTile<3 * NL>>::type tile;
  if constexpr (kSmemTile)
    tile.c = reinterpret_cast<float4(*)[FWD_TILE][3 * NL]>(
        smem_raw + (size_t)rows_per_block * c4 * sizeof(T))[threadIdx.x >> 5];
  fwd_walk<T, NL>(ClusterRows<T>{quad, share, c4, rows_per_block}, tile,
                  p_nor, out, n, c4, run,
                  blockIdx.x * (SMEM_BLOCK(NL) / 32) + (threadIdx.x >> 5),
                  gridDim.x * (SMEM_BLOCK(NL) / 32), threadIdx.x & 31, t);
  // Peers may still be reading this block's shared memory.
  cluster.sync();
}

// `info` receives the blocks launched, the dynamic shared memory of a
// block and whether the tile's coordinates are in shared memory.
template <typename T, int NL, bool kSmemTile>
static cudaError_t launch(const float* p_nor, const T* quad, float* out,
                          int n, int c4, const PlaneTable& t,
                          int coarse_rows, int cluster_blocks,
                          int rows_per_block, int run, cudaStream_t stream,
                          int* info) {
  const size_t smem = (size_t)rows_per_block * c4 * sizeof(T) +
                      (kSmemTile ? tile_bytes<NL>() : 0);
  void (*kernel)(const float*, const T*, float*, int, int, PlaneTable, int,
                 int, int) = plane_sample_fwd_smem_kernel<T, NL, kSmemTile>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster_blocks);
  cfg.blockDim = dim3(SMEM_BLOCK(NL));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // Persistent grid: the clusters that can be resident at once, but no
  // more than the points need.
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long per_cluster =
      (long long)cluster_blocks * (SMEM_BLOCK(NL) / 32) * run;
  clusters = (int)min((long long)clusters,
                      (n + per_cluster - 1) / per_cluster);
  cfg.gridDim = dim3(clusters * cluster_blocks);
  info[0] = clusters * cluster_blocks;
  info[1] = (int)smem;
  info[2] = kSmemTile;
  e = cudaLaunchKernelEx(&cfg, kernel, p_nor, quad, out, n, c4, t,
                         coarse_rows, rows_per_block, run);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The coordinates in shared memory where a block's coarse rows leave room
// for them (measured 4-6 % faster than the shuffles), else in registers.
template <typename T, int NL>
static cudaError_t launch_tile(const float* p_nor, const T* quad, float* out,
                               int n, int c4, const PlaneTable& t,
                               int coarse_rows, int cluster_blocks,
                               int rows_per_block, int run, cudaStream_t s,
                               int* info) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if ((size_t)rows_per_block * c4 * sizeof(T) + tile_bytes<NL>() <=
      (size_t)optin)
    return launch<T, NL, true>(p_nor, quad, out, n, c4, t, coarse_rows,
                               cluster_blocks, rows_per_block, run, s, info);
  return launch<T, NL, false>(p_nor, quad, out, n, c4, t, coarse_rows,
                              cluster_blocks, rows_per_block, run, s, info);
}

template <typename T>
static cudaError_t launch_levels(int n_levels, const float* p_nor,
                                 const void* quad, float* out, int n, int c4,
                                 const PlaneTable& t, int coarse_rows,
                                 int cluster_blocks, int rows_per_block,
                                 int run, cudaStream_t s, int* info) {
  const T* q = (const T*)quad;
  switch (n_levels) {
    case 1: return launch_tile<T, 1>(p_nor, q, out, n, c4, t, coarse_rows,
                                     cluster_blocks, rows_per_block, run, s,
                                     info);
    case 2: return launch_tile<T, 2>(p_nor, q, out, n, c4, t, coarse_rows,
                                     cluster_blocks, rows_per_block, run, s,
                                     info);
    case 3: return launch_tile<T, 3>(p_nor, q, out, n, c4, t, coarse_rows,
                                     cluster_blocks, rows_per_block, run, s,
                                     info);
    default: return launch_tile<T, 4>(p_nor, q, out, n, c4, t, coarse_rows,
                                      cluster_blocks, rows_per_block, run, s,
                                      info);
  }
}

// Plain C interface (bound with ctypes).  `planes` is a host array of
// (H, W, row offset, u-axis, v-axis) per plane; the coarse level is rows
// [0, coarse_rows), split over `cluster_blocks` blocks of
// `rows_per_block` rows; a warp walks runs of `run` (at most one tile)
// points.  `info` (3 ints) receives the number of blocks launched, a
// block's dynamic shared memory and 1 if the tile's coordinates are in
// shared memory (0: registers).  Returns the launch's cudaError_t (0 on
// success); `out` is written on `stream`.
extern "C" int plane_sample_fwd_smem(const float* p_nor, const void* quad,
                                     int quad_bf16, float* out, int n,
                                     int c4, int n_levels, const int* planes,
                                     int coarse_rows, int cluster_blocks,
                                     int rows_per_block, int run, int* info,
                                     void* stream) {
  PlaneTable t;
  if (n <= 0 || c4 <= 0 || c4 % 16 != 0 ||
      !fill_table(&t, planes, n_levels) || cluster_blocks < 1 ||
      cluster_blocks > MAX_CLUSTER || coarse_rows < 1 ||
      rows_per_block < 1 || run < 1 || run > FWD_TILE ||
      (long long)rows_per_block * cluster_blocks < coarse_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (quad_bf16)
    return (int)launch_levels<__nv_bfloat16>(
        n_levels, p_nor, quad, out, n, c4, t, coarse_rows, cluster_blocks,
        rows_per_block, run, s, info);
  return (int)launch_levels<float>(n_levels, p_nor, quad, out, n, c4, t,
                                   coarse_rows, cluster_blocks,
                                   rows_per_block, run, s, info);
}
