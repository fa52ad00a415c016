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
// cluster's distributed shared memory (map_shared_rank).  Coarse rows
// then come from shared memory instead of L2; finer levels are read from
// device memory / L2 as K1 reads them.  The grid is persistent: as many
// whole clusters as can be resident at once (about one block per SM),
// each looping over the points, so each cluster stages the coarse level
// once.  One warp per point, 4 consecutive channels per lane, as in K1.
// Simple and right first: no TMA, no tuning.

#include <cooperative_groups.h>

#include "plane_common.cuh"

namespace cg = cooperative_groups;

#define SMEM_THREADS 1024
#define SMEM_WARPS (SMEM_THREADS / 32)
#define MAX_CLUSTER 8

// 4 consecutive channels through a generic pointer (shared memory of
// this block or of a peer block of the cluster).
__device__ __forceinline__ void shared_load4(const float* src,
                                             float (&g)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
}

__device__ __forceinline__ void shared_load4(const __nv_bfloat16* src,
                                             float (&g)[4]) {
  bf16x4_to_float(*reinterpret_cast<const uint2*>(src), g);
}

// One level of one point: dst[c] = sum_o rows[o][c] * fx_o(c) * fy_o(c).
template <typename T, bool kShared>
__device__ __forceinline__ void sample_level(const T* const* rows,
                                             const PlaneCoord* pc,
                                             float* dst, int lane, int c4) {
  const int C = c4 >> 2;
  for (int c = lane * 4; c < c4; c += 128) {
    const int corner = c / C;  // the 4 channels share a corner (C % 4 == 0)
    const float sx = (corner & 1) ? 1.0f : -1.0f;
    const float sy = (c >= 2 * C) ? 1.0f : -1.0f;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const float fx = 0.5f + (pc[o].wx - 0.5f) * sx;
      const float fy = 0.5f + (pc[o].wy - 0.5f) * sy;
      const float w = fx * fy;
      float g[4];
      if (kShared)
        shared_load4(rows[o] + c, g);
      else
        load4(rows[o] + c, g);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += g[k] * w;
    }
    *reinterpret_cast<float4*>(dst + c) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(SMEM_THREADS, 1)
plane_sample_fwd_smem_kernel(const float* __restrict__ p_nor,
                             const T* __restrict__ quad,
                             float* __restrict__ out, int n, int c4,
                             int n_levels, PlaneTable t, int coarse_rows,
                             int rows_per_block) {
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

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * SMEM_WARPS;
  for (int pt = blockIdx.x * SMEM_WARPS + (threadIdx.x >> 5); pt < n;
       pt += stride) {  // warp-uniform
    const float p[3] = {p_nor[3 * pt], p_nor[3 * pt + 1],
                        p_nor[3 * pt + 2]};
    float* dst = out + (size_t)pt * n_levels * c4;
    for (int l = 0; l < n_levels; ++l) {
      PlaneCoord pc[3];
      const T* rows[3];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        pc[o] = plane_coord(p, t, 3 * l + o);
        if (l == 0) {
          const int owner = pc[o].row / rows_per_block;
          rows[o] = cluster.map_shared_rank(share, owner) +
                    (size_t)(pc[o].row - owner * rows_per_block) * c4;
        } else {
          rows[o] = quad + (size_t)pc[o].row * c4;
        }
      }
      if (l == 0)
        sample_level<T, true>(rows, pc, dst, lane, c4);
      else
        sample_level<T, false>(rows, pc, dst + l * c4, lane, c4);
    }
  }
  // Peers may still be reading this block's shared memory.
  cluster.sync();
}

template <typename T>
static cudaError_t launch(const float* p_nor, const T* quad, float* out,
                          int n, int c4, int n_levels, const PlaneTable& t,
                          int coarse_rows, int cluster_blocks,
                          int rows_per_block, cudaStream_t stream,
                          int* grid_out) {
  const size_t smem = (size_t)rows_per_block * c4 * sizeof(T);
  void (*kernel)(const float*, const T*, float*, int, int, int, PlaneTable,
                 int, int) = plane_sample_fwd_smem_kernel<T>;
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
  cfg.blockDim = dim3(SMEM_THREADS);
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
  const int per_cluster = cluster_blocks * SMEM_WARPS;
  clusters = min(clusters, (n + per_cluster - 1) / per_cluster);
  cfg.gridDim = dim3(clusters * cluster_blocks);
  *grid_out = clusters * cluster_blocks;
  e = cudaLaunchKernelEx(&cfg, kernel, p_nor, quad, out, n, c4, n_levels, t,
                         coarse_rows, rows_per_block);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Plain C interface (bound with ctypes).  `planes` is a host array of
// (H, W, row offset, u-axis, v-axis) per plane; the coarse level is rows
// [0, coarse_rows), split over `cluster_blocks` blocks of
// `rows_per_block` rows.  `grid` receives the number of blocks launched.
// Returns the launch's cudaError_t (0 on success); `out` is written on
// `stream`.
extern "C" int plane_sample_fwd_smem(const float* p_nor, const void* quad,
                                     int quad_bf16, float* out, int n,
                                     int c4, int n_levels, const int* planes,
                                     int coarse_rows, int cluster_blocks,
                                     int rows_per_block, int* grid,
                                     void* stream) {
  PlaneTable t;
  if (n <= 0 || c4 % 16 != 0 || !fill_table(&t, planes, n_levels) ||
      cluster_blocks < 1 || cluster_blocks > MAX_CLUSTER ||
      coarse_rows < 1 || rows_per_block < 1 ||
      (long long)rows_per_block * cluster_blocks < coarse_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (quad_bf16)
    return (int)launch<__nv_bfloat16>(
        p_nor, (const __nv_bfloat16*)quad, out, n, c4, n_levels, t,
        coarse_rows, cluster_blocks, rows_per_block, s, grid);
  return (int)launch<float>(p_nor, (const float*)quad, out, n, c4, n_levels,
                            t, coarse_rows, cluster_blocks, rows_per_block,
                            s, grid);
}
