// Shared pieces of the tri-plane sample kernels (plane_sample.cu,
// plane_sample_smem.cu): the per-plane table, the index math and the
// 4-channel row loads.
//
// Layout (the JAX layout): the quad atlas is (S, 4C), row r holding the
// 2x2 bilinear neighbourhood [tl | tr | bl | br], C channels each; a
// layout has L levels of 3 planes (xy, xz, yz) stacked row-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PLANES 12

struct PlaneTable {
  int H[MAX_PLANES], W[MAX_PLANES], off[MAX_PLANES], au[MAX_PLANES],
      av[MAX_PLANES];
};

struct PlaneCoord {
  int row;
  float wx, wy, in_x, in_y, half_w, half_h;
};

// Same float operations, in the same order, as plane_coords in
// ops/cuda_sample.py and _plane_coords in the JAX package.
__device__ __forceinline__ PlaneCoord plane_coord(const float p[3],
                                                  const PlaneTable& t,
                                                  int k) {
  const float Wm1 = (float)t.W[k] - 1.0f;
  const float Hm1 = (float)t.H[k] - 1.0f;
  const float xr = (p[t.au[k]] + 1.0f) * 0.5f * Wm1;
  const float yr = (p[t.av[k]] + 1.0f) * 0.5f * Hm1;
  const float x = fminf(fmaxf(xr, 0.0f), Wm1);
  const float y = fminf(fmaxf(yr, 0.0f), Hm1);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  PlaneCoord c;
  c.row = t.off[k] + (int)(y0 * (float)t.W[k] + x0);
  c.wx = x - x0;
  c.wy = y - y0;
  c.in_x = (xr >= 0.0f && xr <= Wm1) ? 1.0f : 0.0f;
  c.in_y = (yr >= 0.0f && yr <= Hm1) ? 1.0f : 0.0f;
  c.half_w = 0.5f * Wm1;
  c.half_h = 0.5f * Hm1;
  return c;
}

// 4 consecutive channels from device memory, read-only path.
__device__ __forceinline__ void load4(const float* __restrict__ src,
                                      float (&g)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
}

__device__ __forceinline__ void bf16x4_to_float(uint2 v, float (&g)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  g[0] = fa.x; g[1] = fa.y; g[2] = fb.x; g[3] = fb.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ src,
                                      float (&g)[4]) {
  bf16x4_to_float(__ldg(reinterpret_cast<const uint2*>(src)), g);
}

static inline bool fill_table(PlaneTable* t, const int* planes,
                              int n_levels) {
  const int n_planes = 3 * n_levels;
  if (n_planes < 1 || n_planes > MAX_PLANES) return false;
  for (int k = 0; k < n_planes; ++k) {
    t->H[k] = planes[5 * k];
    t->W[k] = planes[5 * k + 1];
    t->off[k] = planes[5 * k + 2];
    t->au[k] = planes[5 * k + 3];
    t->av[k] = planes[5 * k + 4];
  }
  return true;
}
