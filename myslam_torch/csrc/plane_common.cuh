// Shared pieces of the tri-plane sample kernels (plane_sample.cu,
// plane_sample_smem.cu): the per-plane table, the index math, the
// 4-channel row loads and the forward's walk, which K1 and K3 both take.
//
// Layout (the JAX layout): the quad atlas is (S, 4C), row r holding the
// 2x2 bilinear neighbourhood [tl | tr | bl | br], C channels each; a
// layout has L levels of 3 planes (xy, xz, yz) stacked row-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PLANES 12
#define FULL_MASK 0xffffffffu
// Points whose plane coordinates a forward warp computes at once, one
// per lane: a forward run (K1, K3) is at most one tile.
#define FWD_TILE 32

struct PlaneTable {
  int H[MAX_PLANES], W[MAX_PLANES], off[MAX_PLANES], au[MAX_PLANES],
      av[MAX_PLANES];
};

struct PlaneCoord {
  int row;
  float wx, wy, in_x, in_y;
};

// The (u, v) axes of a level's plane o, in the table's order (xy, xz,
// yz; ORIENTATIONS in models/planes.py); fill_table checks the table
// against them.
__host__ __device__ constexpr int axis_u(int o) { return o == 2 ? 1 : 0; }
__host__ __device__ constexpr int axis_v(int o) { return o == 0 ? 1 : 2; }

// The row a point's cell reads.  NoBand: the whole atlas's row, off +
// y0 * W + x0 (the unbanded kernels).  RowBand: a map shard's band of
// every plane (parallel/plane_shard.py): plane k's rows [y_lo, y_lo +
// band_h) sit at the band atlas's row off (the band's local offset), so
// a point whose cell row floor(y) is in the band reads row off + (floor(y)
// - y_lo) * W + x0, exactly sample_local's index, and any other point
// reads nothing (UNOWNED): it adds zero to the forward and scatters
// nothing in the backward.
#define UNOWNED (-2)
struct NoBand {
  static constexpr bool banded = false;
  __device__ __forceinline__ int row(const PlaneTable& t, int k, float y0,
                                     float x0) const {
    return t.off[k] + (int)(y0 * (float)t.W[k] + x0);
  }
};
struct RowBand {
  static constexpr bool banded = true;
  int y_lo[MAX_PLANES], band_h[MAX_PLANES];
  __device__ __forceinline__ int row(const PlaneTable& t, int k, float y0,
                                     float x0) const {
    const int yb = (int)y0 - y_lo[k];
    return (yb >= 0 && yb < band_h[k]) ? t.off[k] + yb * t.W[k] + (int)x0
                                       : UNOWNED;
  }
};

// Same float operations, in the same order, as plane_coords in
// ops/cuda_sample.py and _plane_coords in the JAX package; u and v are the
// point's coordinates on plane k's axes.
template <class Band = NoBand>
__device__ __forceinline__ PlaneCoord plane_coord_uv(
    float u, float v, const PlaneTable& t, int k,
    const Band& band = Band()) {
  const float Wm1 = (float)t.W[k] - 1.0f;
  const float Hm1 = (float)t.H[k] - 1.0f;
  const float xr = (u + 1.0f) * 0.5f * Wm1;
  const float yr = (v + 1.0f) * 0.5f * Hm1;
  const float x = fminf(fmaxf(xr, 0.0f), Wm1);
  const float y = fminf(fmaxf(yr, 0.0f), Hm1);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  PlaneCoord c;
  c.row = band.row(t, k, y0, x0);
  c.wx = x - x0;
  c.wy = y - y0;
  c.in_x = (xr >= 0.0f && xr <= Wm1) ? 1.0f : 0.0f;
  c.in_y = (yr >= 0.0f && yr <= Hm1) ? 1.0f : 0.0f;
  return c;
}

// Point pt's coordinates on every plane, as (row, wx, wy, in-range bits:
// 1 for x, 2 for y): the index math of all three kernels, run by one
// lane per point.
template <int P, class Band = NoBand>
__device__ __forceinline__ void point_coords(const float* __restrict__ p_nor,
                                             int pt, const PlaneTable& t,
                                             float4 (&pc)[P],
                                             const Band& band = Band()) {
  const float* src = p_nor + 3 * (size_t)pt;
  const float p[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const PlaneCoord c = plane_coord_uv(p[axis_u(k % 3)], p[axis_v(k % 3)],
                                        t, k, band);
    pc[k] = make_float4(__int_as_float(c.row), c.wx, c.wy,
                        __int_as_float((c.in_x != 0.0f ? 1 : 0) |
                                       (c.in_y != 0.0f ? 2 : 0)));
  }
}

// A tile of tn <= 32 points' plane coordinates in a warp's slice of
// shared memory, one lane per point (K1, K2).
template <int P, class Band = NoBand>
__device__ __forceinline__ void tile_coords(float4 (*dst)[P],
                                            const float* __restrict__ p_nor,
                                            int tile, int tn, int lane,
                                            const PlaneTable& t,
                                            const Band& band = Band()) {
  __syncwarp();  // every lane is done with the previous tile
  if (lane < tn) point_coords<P>(p_nor, tile + lane, t, dst[lane], band);
  __syncwarp();
}

__device__ __forceinline__ void bf16x4_to_float(uint2 v, float (&g)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  g[0] = fa.x; g[1] = fa.y; g[2] = fb.x; g[3] = fb.y;
}

// A quad row's 4 channels as a lane holds them in registers: a float4 in
// f32, 4 packed bfloat16 in bf16 (half the registers).  `load` reads
// device memory through the read-only path, `load_generic` any address
// (shared memory of this block or of a peer block of the cluster).
template <typename T> struct Row4;
template <> struct Row4<float> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* src) {
    return __ldg(reinterpret_cast<const float4*>(src));
  }
  static __device__ __forceinline__ V load_generic(const float* src) {
    return *reinterpret_cast<const float4*>(src);
  }
  static __device__ __forceinline__ void unpack(V v, float (&g)[4]) {
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  }
  static __device__ __forceinline__ V zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};
template <> struct Row4<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ V load(const __nv_bfloat16* src) {
    return __ldg(reinterpret_cast<const uint2*>(src));
  }
  static __device__ __forceinline__ V load_generic(const __nv_bfloat16* src) {
    return *reinterpret_cast<const uint2*>(src);
  }
  static __device__ __forceinline__ void unpack(V v, float (&g)[4]) {
    bf16x4_to_float(v, g);
  }
  static __device__ __forceinline__ V zero() { return make_uint2(0u, 0u); }
};

// Every plane's rows from device memory (K1).
template <typename T>
struct GlobalRows {
  const T* __restrict__ quad;
  int c4;
  __device__ __forceinline__ typename Row4<T>::V load(int k, int row,
                                                      int c) const {
    return Row4<T>::load(quad + (size_t)row * c4 + c);
  }
};

// A tile's coordinates in shared memory, read back by broadcast (K1, and
// K3 where the coarse rows leave room).
template <int P>
struct SmemTile {
  float4 (*c)[P];
  template <class Band>
  __device__ __forceinline__ void fill(const float* __restrict__ p_nor,
                                       int tile, int tn, int lane,
                                       const PlaneTable& t,
                                       const Band& band) {
    tile_coords<P>(c, p_nor, tile, tn, lane, t, band);
  }
  __device__ __forceinline__ int row(int i, int k) const {
    return __float_as_int(c[i][k].x);
  }
  __device__ __forceinline__ float2 frac(int i, int k) const {
    const float4 v = c[i][k];
    return make_float2(v.y, v.z);
  }
};

// A tile's coordinates in the registers of the lane that computed them,
// read back by shuffles (K3 where the coarse rows fill shared memory).
template <int P>
struct ShflTile {
  float4 c[P];
  template <class Band>
  __device__ __forceinline__ void fill(const float* __restrict__ p_nor,
                                       int tile, int tn, int lane,
                                       const PlaneTable& t,
                                       const Band& band) {
    if (lane < tn) point_coords<P>(p_nor, tile + lane, t, c, band);
  }
  __device__ __forceinline__ int row(int i, int k) const {
    return __shfl_sync(FULL_MASK, __float_as_int(c[k].x), i);
  }
  __device__ __forceinline__ float2 frac(int i, int k) const {
    return make_float2(__shfl_sync(FULL_MASK, c[k].y, i),
                       __shfl_sync(FULL_MASK, c[k].z, i));
  }
};

// The rows of point i of a tile that the warp does not hold yet, one
// load per plane whose row differs from the held one (warp-uniform).
// Every plane's row index is read first, so that no load waits on the
// next plane's index.  Banded: an UNOWNED point holds a zero row.
template <typename T, int P, bool Banded = false, class Rows, class Tile>
__device__ __forceinline__ void fetch_rows(const Rows& rows, const Tile& tile,
                                           int i, int c, bool on,
                                           int (&held_row)[P],
                                           typename Row4<T>::V (&held)[P]) {
  int r[P];
#pragma unroll
  for (int k = 0; k < P; ++k) r[k] = tile.row(i, k);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (r[k] != held_row[k]) {
      held_row[k] = r[k];
      if constexpr (Banded) {
        if (on)
          held[k] = r[k] >= 0 ? rows.load(k, r[k], c) : Row4<T>::zero();
      } else {
        if (on) held[k] = rows.load(k, r[k], c);
      }
    }
  }
}

// The forward walk of K1 and K3:
//   out[n, l*c4 + c] = sum over level l's planes o = 0, 1, 2 (in that
//   order, as the plain version sums) of quad[row, c] * fx(c) * fy(c).
// Warp gw walks runs gw, gw + stride, ... of `run` (<= FWD_TILE)
// consecutive points, 128 channels per pass.  Per run, one lane per point
// computes the plane coordinates (Tile); then, per point, a plane's row is
// loaded only where it differs from the row the warp holds for that plane
// (warp-uniform: every lane has the same point), all of the point's loads
// issue together (levels unrolled), the next point's loads issue before
// this point's output is stored, and the output goes out with streaming
// 16-byte stores so that it does not evict the atlas rows from L2.
//
// With a RowBand (K1's banded instantiation) every plane's row index is
// the band's, and a point outside a plane's band holds a zero row for it:
// the walk is otherwise the same code.
template <typename T, int NL, class Rows, class Tile, class Band = NoBand>
__device__ __forceinline__ void fwd_walk(const Rows& rows, Tile& tile,
                                         const float* __restrict__ p_nor,
                                         float* __restrict__ out, int n,
                                         int c4, int run, int gw, int stride,
                                         int lane, const PlaneTable& t,
                                         const Band& band = Band()) {
  constexpr int P = 3 * NL;
  const int C = c4 >> 2;
  const size_t out_stride = (size_t)NL * c4;
  for (int base = 0; base < c4; base += 128) {
    const int c = base + lane * 4;
    const bool on = c < c4;  // lanes past a row narrower than 128
    const int corner = c / C;  // the 4 channels share a corner (C % 4 == 0)
    const float sx = (corner & 1) ? 1.0f : -1.0f;
    const float sy = (corner >= 2) ? 1.0f : -1.0f;
    int held_row[P];
    typename Row4<T>::V held[P];
#pragma unroll
    for (int k = 0; k < P; ++k) held_row[k] = -1;
    for (int first = gw * run; first < n; first += stride * run) {
      const int tn = min(run, n - first);
      tile.fill(p_nor, first, tn, lane, t, band);
      fetch_rows<T, P, Band::banded>(rows, tile, 0, c, on, held_row, held);
      for (int i = 0; i < tn; ++i) {
        float acc[NL][4];
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int l = k / 3;
          const float2 w2 = tile.frac(i, k);
          const float fx = 0.5f + (w2.x - 0.5f) * sx;
          const float fy = 0.5f + (w2.y - 0.5f) * sy;
          const float w = fx * fy;
          float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (on) Row4<T>::unpack(held[k], g);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[l][j] = (k % 3 == 0) ? g[j] * w : acc[l][j] + g[j] * w;
        }
        if (i + 1 < tn)  // in flight while this point stores
          fetch_rows<T, P, Band::banded>(rows, tile, i + 1, c, on, held_row,
                                         held);
        if (on) {
          float* dst = out + (size_t)(first + i) * out_stride + c;
#pragma unroll
          for (int l = 0; l < NL; ++l)
            __stcs(reinterpret_cast<float4*>(dst + l * c4),
                   make_float4(acc[l][0], acc[l][1], acc[l][2], acc[l][3]));
        }
      }
    }
  }
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
    // The kernels take the axes from the orientation (axis_u, axis_v).
    if (t->au[k] != axis_u(k % 3) || t->av[k] != axis_v(k % 3)) return false;
  }
  return true;
}


// A band table from the host array of (y_lo, band_h) per plane: every
// band starts at a row >= 0 and is non-empty (a band may reach past its
// plane's last row: those are padding rows that no point reads).
static inline bool fill_band(RowBand* b, const int* bands, int n_levels) {
  for (int k = 0; k < 3 * n_levels; ++k) {
    b->y_lo[k] = bands[2 * k];
    b->band_h[k] = bands[2 * k + 1];
    if (b->y_lo[k] < 0 || b->band_h[k] < 1) return false;
  }
  return true;
}
