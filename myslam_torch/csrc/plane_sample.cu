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
// What bounds them on an H100: bytes, not operations.  K1 does ~4 flops
// per output element and writes 4C*L floats per point (164 MB for the
// 160,000-point mapping SDF call, ~50 us at 3.35 TB/s); the 6 row reads
// per point (512 B each in f32, 256 B in bf16) come mostly from L2,
// since the quad atlases (6.3 MB SDF, 24.1 MB color in f32) fit in the
// 50 MB L2.  K2 reads gbar (the same 164 MB) and re-reads the rows; its
// quad gradient is a scatter-add, bound by f32 atomic throughput in L2
// where many points hit one row (the coarse planes).
//
// Design: one warp per point.  Each lane owns 4 consecutive channels of
// the 4C-wide row, so a 128-wide f32 row is one coalesced 16-byte load
// per lane (8 bytes in bf16) and the output store is coalesced too.  The
// plane index math is warp-uniform.  K2 re-reads each row instead of
// keeping the forward's gathered rows as a residual (491 MB in f32 at
// 160,000 points), reduces the coordinate gradient across the warp with
// shuffles (the warp owns its point, so p_grad needs no atomics), and
// adds the quad gradient with f32 atomics, which replace both the
// scatter and the TPU's bf16 one-hot matmul route.  Simple and right
// first: no TMA, no shared-memory staging, no tuning.

#include "plane_common.cuh"

#define WARPS_PER_BLOCK 8

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
template <typename T>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
plane_sample_bwd_kernel(const float* __restrict__ gbar,
                        const float* __restrict__ p_nor,
                        const T* __restrict__ quad,
                        float* __restrict__ quad_grad,
                        float* __restrict__ p_grad, int n, int c4,
                        int n_levels, PlaneTable t) {
  const int pt = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pt >= n) return;  // warp-uniform
  const float p[3] = {p_nor[3 * pt], p_nor[3 * pt + 1], p_nor[3 * pt + 2]};
  const int C = c4 >> 2;
  const float* gsrc = gbar + (size_t)pt * n_levels * c4;
  float pg[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < n_levels; ++l) {
    PlaneCoord pc[3];
    float dwx[3] = {0.0f, 0.0f, 0.0f};
    float dwy[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < 3; ++o) pc[o] = plane_coord(p, t, 3 * l + o);
    for (int c = lane * 4; c < c4; c += 128) {
      const int corner = c / C;
      const float sx = (corner & 1) ? 1.0f : -1.0f;
      const float sy = (c >= 2 * C) ? 1.0f : -1.0f;
      float gl[4];
      load4(gsrc + l * c4 + c, gl);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float fx = 0.5f + (pc[o].wx - 0.5f) * sx;
        const float fy = 0.5f + (pc[o].wy - 0.5f) * sy;
        if (quad_grad != nullptr) {
          const float f = fx * fy;
          float* qg = quad_grad + (size_t)pc[o].row * c4 + c;
#pragma unroll
          for (int k = 0; k < 4; ++k) atomicAdd(qg + k, gl[k] * f);
        }
        float g[4];
        load4(quad + (size_t)pc[o].row * c4 + c, g);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float ggl = g[k] * gl[k];
          dwx[o] += ggl * (sx * fy);
          dwy[o] += ggl * (sy * fx);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int k = 3 * l + o;
      const float sx_sum = warp_sum(dwx[o]);
      const float sy_sum = warp_sum(dwy[o]);
      pg[t.au[k]] += sx_sum * pc[o].in_x * pc[o].half_w;
      pg[t.av[k]] += sy_sum * pc[o].in_y * pc[o].half_h;
    }
  }
  if (lane == 0) {
    p_grad[3 * pt] = pg[0];
    p_grad[3 * pt + 1] = pg[1];
    p_grad[3 * pt + 2] = pg[2];
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

extern "C" int plane_sample_bwd(const float* gbar, const float* p_nor,
                                const void* quad, int quad_bf16,
                                float* quad_grad, float* p_grad, int n,
                                int c4, int n_levels, const int* planes,
                                void* stream) {
  PlaneTable t;
  if (n <= 0 || c4 % 16 != 0 || !fill_table(&t, planes, n_levels))
    return (int)cudaErrorInvalidValue;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  if (quad_bf16)
    plane_sample_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        gbar, p_nor, (const __nv_bfloat16*)quad, quad_grad, p_grad, n, c4,
        n_levels, t);
  else
    plane_sample_bwd_kernel<float><<<grid, block, 0, s>>>(
        gbar, p_nor, (const float*)quad, quad_grad, p_grad, n, c4, n_levels,
        t);
  return (int)cudaGetLastError();
}
