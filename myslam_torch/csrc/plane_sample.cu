// Tri-plane quad-atlas sampling on Hopper (sm_90a): kernels K1 and K2.
//
// K1 plane_sample_fwd replaces the TPU forward kernels of
// myslam_tpu/ops/pallas_sample.py: make_sample_quad_pallas_dma (B1) with
// the index math of sample_fused_pallas / plane_indices_and_fracs (B3),
// i.e. the forward of myslam_tpu/ops/plane_sample.py::sample_fused.
// K2 plane_sample_bwd replaces the hand-written VJP of the same function,
// _sample_fused_bwd with _scatter_grad (plane_sample.py:328-378).
//
// Layout: see plane_common.cuh.  The sample output is (N, L*4C)
// float32: per level, the three planes' rows weighted in lane space by
// (0.5 + (wx-0.5)*sx) * (0.5 + (wy-0.5)*sy) (sx = +1 on the right corners, sy = +1 on the bottom corners) and
// summed.  Index math: grid_sample align_corners=True, border clamp.
//
// K1: what bounds it on an H100 is bytes, not operations.  It does ~4
// flops per output element and writes 4C*L floats per point (164 MB
// for the 160,000-point mapping SDF call, ~50 us at 3.35 TB/s); the 6
// row reads per point (512 B each in f32, 256 B in bf16) come mostly
// from L2, since the quad atlases (6.3 MB SDF, 24.1 MB color in f32) fit
// in the 50 MB L2.  Design: one warp per point.  Each lane owns 4
// consecutive channels of the 4C-wide row, so a 128-wide f32 row is one
// coalesced 16-byte load per lane (8 bytes in bf16) and the output store
// is coalesced too.  The plane index math is warp-uniform.
//
// K2: what bounds it is the read of gbar, the same 164 MB (0.053 ms at
// 3.35 TB/s with the quad rows and the quad gradient's rows).  The first
// design took 0.78 ms on uniform points and 1.94 ms on the loop's own:
// a warp per point issued 4 scalar f32 atomics per lane per plane (123 M
// atomics per 160,000-point call, at the rate of L2's atomic units and
// serialised on the hot coarse rows, which the first samples of every
// ray share), 12 warp sums of 5 shuffles each per point, and kept only
// one point's loads in flight.  This design, for the SLAM loop's points
// (ray-major: a ray's 40 samples are consecutive and often share a row):
//   1. A warp walks a run of `run` consecutive points (the wrapper's
//      constant).  Per plane it keeps the current row and a 4-float
//      quad-gradient accumulator per lane; when the plane's row changes
//      (warp-uniform: every lane has the same point) it flushes the
//      accumulator, and it flushes all of them at the end of the run.
//      On the loop's mapping SDF points, runs of 16 merge the 960,000
//      (point, plane) updates into ~445,000.
//   2. A flush is one 16-byte vector reduction per lane,
//      atomicAdd(float4*, float4) (REDG.E.ADD.F32x4 on sm_90), not 4
//      scalar atomics.
//   3. The coordinate gradient reuses the quad row the warp holds in
//      registers while the plane's row does not change.
//   4. The coordinate gradient's 12 per-point sums (dwx, dwy of 6
//      planes) are folded per lane into the 3 axes first (the in-range
//      masks and half extents are per point, equal on every lane), then
//      summed over the warp by one transposing butterfly: 6 shuffles per
//      point instead of 60.  Lanes 0, 8 and 16 write p_grad's 3 axes, so
//      p_grad needs no atomics.
//   5. The next point's gbar row is loaded before this point's warp sum,
//      so it is in flight while the warp reduces; gbar is read once, with
//      the streaming hint.
// The plane index math (plane_coord_uv, K1's own) runs once per (point,
// plane), lane-parallel over a tile of 16 points, into shared memory,
// instead of on all 32 lanes for every point: it was most of the
// instructions of the first design.  Without the quad gradient
// (tracking's frozen quads) K2 takes the same walk without 1-2.  Sums
// run in another order than the plain version: merged runs sum in
// registers before their atomic, and atomics add in an order that
// changes from run to run.  No global scratch memory, no
// synchronisation; the launch is one kernel on the caller's stream.
// Simple and right first for K1: no TMA, no shared-memory staging.

#include "plane_common.cuh"

#define WARPS_PER_BLOCK 8
// K2's warps per block; the wrapper's launch plan must name the same.
#define BWD_WARPS 8
// Points whose plane coordinates a K2 warp computes at once.
#define BWD_TILE 16
// K2's blocks per SM that ptxas must fit in registers: 2 (at most 128
// registers) for the loop's 1-2 levels, where ptxas left alone aims
// lower and spills; 1 for 3-4 levels, which need more.
#define BWD_MIN_BLOCKS(NL) ((NL) <= 2 ? 2 : 1)
#define FULL_MASK 0xffffffffu

// The (u, v) axes of a level's plane o, in the table's order (xy, xz,
// yz; ORIENTATIONS in models/planes.py); plane_sample_bwd checks the
// table against them.
__host__ __device__ constexpr int axis_u(int o) { return o == 2 ? 1 : 0; }
__host__ __device__ constexpr int axis_v(int o) { return o == 0 ? 1 : 2; }

// A quad row's 4 channels as K2 holds them in registers: a float4 in
// f32, 4 packed bfloat16 in bf16 (half the registers).
template <typename T> struct Row4;
template <> struct Row4<float> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* src) {
    return __ldg(reinterpret_cast<const float4*>(src));
  }
  static __device__ __forceinline__ void unpack(V v, float (&g)[4]) {
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  }
};
template <> struct Row4<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ V load(const __nv_bfloat16* src) {
    return __ldg(reinterpret_cast<const uint2*>(src));
  }
  static __device__ __forceinline__ void unpack(V v, float (&g)[4]) {
    bf16x4_to_float(v, g);
  }
};

// One point's gbar lanes of every level: 16 bytes per lane and level,
// read once (streaming); zeros on lanes past the row.
template <int NL>
__device__ __forceinline__ void load_gbar(float (&gl)[NL][4],
                                          const float* src, int c4,
                                          bool on) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const float4 v =
        on ? __ldcs(reinterpret_cast<const float4*>(src + l * c4))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    gl[l][0] = v.x; gl[l][1] = v.y; gl[l][2] = v.z; gl[l][3] = v.w;
  }
}

// The warp's sum of v[0..2], by a transposing butterfly over 4 values
// (the 4th is 0): at offsets 16 and 8 each lane hands half of its
// partial sums to its partner and keeps the other half, then offsets 4,
// 2 and 1 finish one value per lane.  6 shuffles; lane i returns the
// total of v[i >> 3] (lanes 24-31: 0).
__device__ __forceinline__ float warp_sum3(const float (&v)[3], int lane) {
  const bool hi16 = lane & 16;
  const float u0 = (hi16 ? v[2] : v[0]) +
                   __shfl_xor_sync(FULL_MASK, hi16 ? v[0] : v[2], 16);
  const float u1 = (hi16 ? 0.0f : v[1]) +
                   __shfl_xor_sync(FULL_MASK, hi16 ? v[1] : 0.0f, 16);
  const bool hi8 = lane & 8;
  float w = (hi8 ? u1 : u0) + __shfl_xor_sync(FULL_MASK, hi8 ? u0 : u1, 8);
  w += __shfl_xor_sync(FULL_MASK, w, 4);
  w += __shfl_xor_sync(FULL_MASK, w, 2);
  w += __shfl_xor_sync(FULL_MASK, w, 1);
  return w;
}

// K1: out[n, l*c4 + c] = sum over the level's 3 planes of
//     quad[row, c] * fx(c) * fy(c).
template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
plane_sample_fwd_kernel(const float* __restrict__ p_nor,
                        const T* __restrict__ quad, float* __restrict__ out,
                        int n, int c4, int n_levels, PlaneTable t) {
  const int pt = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pt >= n) return;  // warp-uniform
  const float p[3] = {p_nor[3 * pt], p_nor[3 * pt + 1], p_nor[3 * pt + 2]};
  const int C = c4 >> 2;
  float* dst = out + (size_t)pt * n_levels * c4;
  for (int l = 0; l < n_levels; ++l) {
    PlaneCoord pc[3];
#pragma unroll
    for (int o = 0; o < 3; ++o) pc[o] = plane_coord(p, t, 3 * l + o);
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
        load4(quad + (size_t)pc[o].row * c4 + c, g);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += g[k] * w;
      }
      *reinterpret_cast<float4*>(dst + l * c4 + c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// K2: quad_grad[row, c] += gbar[n, l*c4 + c] * fx(c) * fy(c)  (if asked)
//     p_grad[n, au] += in_x * 0.5(W-1) * sum_c quad[row,c] gbar[n,c] sx fy
//     p_grad[n, av] += in_y * 0.5(H-1) * sum_c quad[row,c] gbar[n,c] sy fx
// Warp w walks points [w*run, min((w+1)*run, n)), 128 channels per pass
// (one pass for the loop's c4 = 128; later passes add to p_grad), in
// tiles of BWD_TILE points whose plane coordinates it computes first,
// one point per lane, into shared memory.
template <typename T, int NL, bool QUAD_GRAD>
__global__ void __launch_bounds__(BWD_WARPS * 32, BWD_MIN_BLOCKS(NL))
plane_sample_bwd_kernel(const float* __restrict__ gbar,
                        const float* __restrict__ p_nor,
                        const T* __restrict__ quad,
                        float* __restrict__ quad_grad,
                        float* __restrict__ p_grad, int n, int c4, int run,
                        PlaneTable t) {
  constexpr int P = 3 * NL;
  // Per warp, per (point, plane) of a tile: row, wx, wy, in-range bits.
  __shared__ float4 coords[BWD_WARPS][BWD_TILE][P];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * BWD_WARPS + warp) * run;
  if (first >= n) return;  // warp-uniform
  const int end = min(first + run, n);
  const int C = c4 >> 2;
  const size_t stride = (size_t)NL * c4;
  for (int base = 0; base < c4; base += 128) {
    const int c = base + lane * 4;
    const bool on = c < c4;  // lanes past a row narrower than 128
    const int corner = c / C;
    const float sx = (corner & 1) ? 1.0f : -1.0f;
    const float sy = (corner >= 2) ? 1.0f : -1.0f;
    int row[P];
    typename Row4<T>::V held[P];
    float acc[P][4];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      row[k] = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;
    }
    float gl[NL][4];  // this point's gbar lanes
    load_gbar<NL>(gl, gbar + first * stride + c, c4, on);
    for (int tile = first; tile < end; tile += BWD_TILE) {
      const int tn = min(BWD_TILE, end - tile);
      __syncwarp();
      if (lane < tn) {
        const float* src = p_nor + 3 * (size_t)(tile + lane);
        const float p[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const PlaneCoord pc = plane_coord_uv(p[axis_u(k % 3)],
                                               p[axis_v(k % 3)], t, k);
          coords[warp][lane][k] = make_float4(
              __int_as_float(pc.row), pc.wx, pc.wy,
              __int_as_float((pc.in_x != 0.0f ? 1 : 0) |
                             (pc.in_y != 0.0f ? 2 : 0)));
        }
      }
      __syncwarp();
      for (int i = 0; i < tn; ++i) {
        const int pt = tile + i;
        // Rows first, so that every plane's row load is in flight at once.
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int r = __float_as_int(coords[warp][i][k].x);
          if (r != row[k]) {  // warp-uniform: every lane has this point
            if (QUAD_GRAD && row[k] >= 0 && on) {  // item 1: flush the run
              atomicAdd(reinterpret_cast<float4*>(
                            quad_grad + (size_t)row[k] * c4 + c),
                        make_float4(acc[k][0], acc[k][1], acc[k][2],
                                    acc[k][3]));  // item 2: one vector red
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[k][j] = 0.0f;
            }
            row[k] = r;
            if (on) held[k] = Row4<T>::load(quad + (size_t)r * c4 + c);
          }
        }
        float pg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const float4 cd = coords[warp][i][k];
          const int l = k / 3, o = k % 3;
          float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (on) Row4<T>::unpack(held[k], g);  // item 3: the held row
          const float fx = 0.5f + (cd.y - 0.5f) * sx;
          const float fy = 0.5f + (cd.z - 0.5f) * sy;
          float ggl = 0.0f;  // sum_c quad[row, c] gbar[n, c] on this lane
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (QUAD_GRAD) acc[k][j] += gl[l][j] * (fx * fy);
            ggl += g[j] * gl[l][j];
          }
          // Item 4: fold into the axes on each lane (sx, sy, fx, fy are
          // one lane's corner), sum over the warp once.
          const int in = __float_as_int(cd.w);
          if (in & 1) pg[axis_u(o)] += ggl * (sx * fy) *
                                       (0.5f * ((float)t.W[k] - 1.0f));
          if (in & 2) pg[axis_v(o)] += ggl * (sy * fx) *
                                       (0.5f * ((float)t.H[k] - 1.0f));
        }
        if (pt + 1 < end)  // item 5: in flight while the warp sums
          load_gbar<NL>(gl, gbar + (pt + 1) * stride + c, c4, on);
        const float s = warp_sum3(pg, lane);
        if ((lane & 7) == 0 && lane < 24) {
          float* dst = p_grad + 3 * (size_t)pt + (lane >> 3);
          *dst = base == 0 ? s : *dst + s;
        }
      }
    }
    if (QUAD_GRAD && on) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (row[k] >= 0)
          atomicAdd(reinterpret_cast<float4*>(
                        quad_grad + (size_t)row[k] * c4 + c),
                    make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]));
    }
  }
}

template <typename T, int NL>
static void launch_bwd(dim3 grid, cudaStream_t s, const float* gbar,
                       const float* p_nor, const T* quad, float* quad_grad,
                       float* p_grad, int n, int c4, int run,
                       const PlaneTable& t) {
  const dim3 block(BWD_WARPS * 32);
  if (quad_grad != nullptr)
    plane_sample_bwd_kernel<T, NL, true><<<grid, block, 0, s>>>(
        gbar, p_nor, quad, quad_grad, p_grad, n, c4, run, t);
  else
    plane_sample_bwd_kernel<T, NL, false><<<grid, block, 0, s>>>(
        gbar, p_nor, quad, nullptr, p_grad, n, c4, run, t);
}

template <typename T>
static void launch_bwd_levels(int n_levels, dim3 grid, cudaStream_t s,
                              const float* gbar, const float* p_nor,
                              const void* quad, float* quad_grad,
                              float* p_grad, int n, int c4, int run,
                              const PlaneTable& t) {
  const T* q = (const T*)quad;
  switch (n_levels) {
    case 1: launch_bwd<T, 1>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t); break;
    case 2: launch_bwd<T, 2>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t); break;
    case 3: launch_bwd<T, 3>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t); break;
    default: launch_bwd<T, 4>(grid, s, gbar, p_nor, q, quad_grad, p_grad,
                              n, c4, run, t); break;
  }
}

// Plain C interface (bound with ctypes).  `planes` is a host array of
// (H, W, row offset, u-axis, v-axis) per plane.  Returns the launch's
// cudaGetLastError() (0 on success); outputs are written on `stream`.
extern "C" int plane_sample_fwd(const float* p_nor, const void* quad,
                                int quad_bf16, float* out, int n, int c4,
                                int n_levels, const int* planes,
                                void* stream) {
  PlaneTable t;
  if (n <= 0 || c4 % 16 != 0 || !fill_table(&t, planes, n_levels))
    return (int)cudaErrorInvalidValue;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (quad_bf16)
    plane_sample_fwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        p_nor, (const __nv_bfloat16*)quad, out, n, c4, n_levels, t);
  else
    plane_sample_fwd_kernel<float><<<grid, block, 0, s>>>(
        p_nor, (const float*)quad, out, n, c4, n_levels, t);
  return (int)cudaGetLastError();
}

// `run`, `warps` and `blocks` are the wrapper's launch plan: warp w of
// the grid walks points [w*run, min((w+1)*run, n)); the plan must cover
// every point with no empty block.
extern "C" int plane_sample_bwd(const float* gbar, const float* p_nor,
                                const void* quad, int quad_bf16,
                                float* quad_grad, float* p_grad, int n,
                                int c4, int n_levels, const int* planes,
                                int run, int warps, int blocks,
                                void* stream) {
  PlaneTable t;
  const long long per_block = (long long)warps * run;
  if (n <= 0 || c4 <= 0 || c4 % 16 != 0 ||
      !fill_table(&t, planes, n_levels) || warps != BWD_WARPS ||
      run <= 0 || blocks <= 0 || per_block * blocks < n ||
      per_block * (blocks - 1) >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks);
  if (quad_bf16)
    launch_bwd_levels<__nv_bfloat16>(n_levels, grid, s, gbar, p_nor, quad,
                                     quad_grad, p_grad, n, c4, run, t);
  else
    launch_bwd_levels<float>(n_levels, grid, s, gbar, p_nor, quad,
                             quad_grad, p_grad, n, c4, run, t);
  return (int)cudaGetLastError();
}
