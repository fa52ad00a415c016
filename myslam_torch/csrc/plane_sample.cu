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
// in the 50 MB L2.  The first design (a warp per point, every lane
// redoing the 6 planes' index math, a runtime level loop, plain stores)
// stayed at half that bound and was slower with a bf16 quad, which moves
// half the row bytes, than with an f32 one: instructions and latency, not
// bytes, held it.  This design is K2's walk (plane_common.cuh, fwd_walk,
// which K3 shares):
//   1. A warp walks a run of `run` consecutive points (the wrapper's
//      launch plan, fwd_launch_plan, which the C entry checks; 8, chosen
//      on the card among 4-32).  A persistent grid striding over the runs
//      measured no faster.
//   2. The index math runs once per (point, plane), one lane per point,
//      into shared memory (tile_coords, K2's too).
//   3. Levels are a template parameter: all 3L row loads of a point issue
//      together, and the next point's loads issue before this point's
//      output is stored.
//   4. A plane's row is loaded only where it differs from the row the
//      warp holds for that plane: the loop's ray-ordered points share
//      rows, and runs of 8 merge 960,000 (point, plane) row reads of the
//      mapping SDF sample to ~470,000.
//   5. The output goes out with streaming 16-byte stores (__stcs), so
//      that it does not evict the atlas rows from L2.
//   6. ptxas gets a register budget per level count (FWD_MIN_BLOCKS) and
//      must not spill (chip_smoke.py fails the build if it does).
// Each lane owns 4 consecutive channels of the 4C-wide row (passes of
// 128 channels), so a row load is one coalesced 16-byte load per lane
// (8 bytes in bf16) and a store is coalesced too.  The three planes of a
// level are summed in the plain version's order.
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
// The plane index math (tile_coords, K1's too) runs once per (point,
// plane), lane-parallel over a tile of 16 points, into shared memory,
// instead of on all 32 lanes for every point: it was most of the
// instructions of the first design.  Without the quad gradient
// (tracking's frozen quads) K2 takes the same walk without 1-2.  Sums
// run in another order than the plain version: merged runs sum in
// registers before their atomic, and atomics add in an order that
// changes from run to run.  No global scratch memory, no
// synchronisation; the launch is one kernel on the caller's stream.
//
// Banded K1 / K2 (plane_sample_fwd_banded, plane_sample_bwd_banded) work
// on one map shard's band atlas (parallel/plane_shard.py, the counterpart
// of myslam_tpu/parallel/plane_shard.py's owned-row sample, which JAX
// runs as a plain XLA gather): the band table adds each plane's (y_lo,
// band_h), a point whose cell row lies outside its plane's band reads a
// zero row (forward) and scatters nothing (backward), and the row index
// is the band's (RowBand in plane_common.cuh).  Banded K1 is K1's walk,
// its RowBand instantiation; banded K2 has a design of its own, which
// walks only the points the band owns (plane_sample_bwd_banded_kernel).

#include "plane_common.cuh"

// K1's warps per block; the wrapper's launch plan must name the same.
#define FWD_WARPS 8
// K1's blocks per SM that ptxas must fit in registers: 4 (at most 64
// registers, which the 1-2 level variants fit without spilling; 3 was
// slower with an f32 quad) for 1-2 levels, 2 for 3-4, which hold more
// rows.
#define FWD_MIN_BLOCKS(NL) ((NL) <= 2 ? 4 : 2)
// K2's warps per block; the wrapper's launch plan must name the same.
#define BWD_WARPS 8
// Points whose plane coordinates a K2 warp computes at once.
#define BWD_TILE 16
// K2's blocks per SM that ptxas must fit in registers: 2 (at most 128
// registers) for the loop's 1-2 levels, where ptxas left alone aims
// lower and spills; 1 for 3-4 levels, which need more.
#define BWD_MIN_BLOCKS(NL) ((NL) <= 2 ? 2 : 1)

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
//     quad[row, c] * fx(c) * fy(c), by fwd_walk.
template <typename T, int NL, class Band>
__device__ __forceinline__ void fwd_body(const float* __restrict__ p_nor,
                                         const T* __restrict__ quad,
                                         float* __restrict__ out, int n,
                                         int c4, int run, const PlaneTable& t,
                                         const Band& band) {
  __shared__ float4 coords[FWD_WARPS][FWD_TILE][3 * NL];
  const int warp = threadIdx.x >> 5;
  SmemTile<3 * NL> tile{coords[warp]};
  fwd_walk<T, NL>(GlobalRows<T>{quad, c4}, tile, p_nor, out, n, c4, run,
                  blockIdx.x * FWD_WARPS + warp, gridDim.x * FWD_WARPS,
                  threadIdx.x & 31, t, band);
}

template <typename T, int NL>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_MIN_BLOCKS(NL))
plane_sample_fwd_kernel(const float* __restrict__ p_nor,
                        const T* __restrict__ quad, float* __restrict__ out,
                        int n, int c4, int run, PlaneTable t) {
  fwd_body<T, NL>(p_nor, quad, out, n, c4, run, t, NoBand());
}

// Banded K1: the same walk over a band atlas (RowBand).
template <typename T, int NL>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_MIN_BLOCKS(NL))
plane_sample_fwd_banded_kernel(const float* __restrict__ p_nor,
                               const T* __restrict__ quad,
                               float* __restrict__ out, int n, int c4,
                               int run, PlaneTable t, RowBand band) {
  fwd_body<T, NL>(p_nor, quad, out, n, c4, run, t, band);
}

// Adds a merged run's quad gradient to this lane's 4 channels of its row
// and clears the run: one 16-byte vector reduction per lane (K2's items
// 1-2; banded K2's too).
__device__ __forceinline__ void flush_row(float* dst, float (&acc)[4]) {
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4(acc[0], acc[1], acc[2], acc[3]));
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.0f;
}

// Lanes 0, 8 and 16 hold the warp's sums of the 3 axes (warp_sum3): the
// point's p_grad row, set on the first 128-channel pass and added to on
// later ones.  No atomics: one warp owns the point.
__device__ __forceinline__ void store_p_grad(float* __restrict__ p_grad,
                                             int pt, int base, float s,
                                             int lane) {
  if ((lane & 7) == 0 && lane < 24) {
    float* dst = p_grad + 3 * (size_t)pt + (lane >> 3);
    *dst = base == 0 ? s : *dst + s;
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
      tile_coords<P>(coords[warp], p_nor, tile, tn, lane, t);
      for (int i = 0; i < tn; ++i) {
        const int pt = tile + i;
        // Rows first, so that every plane's row load is in flight at once.
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const int r = __float_as_int(coords[warp][i][k].x);
          if (r != row[k]) {  // warp-uniform: every lane has this point
            if (QUAD_GRAD && row[k] >= 0 && on)  // item 1: flush the run
              flush_row(quad_grad + (size_t)row[k] * c4 + c,
                        acc[k]);  // item 2
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
        store_p_grad(p_grad, pt, base, warp_sum3(pg, lane), lane);
      }
    }
    if (QUAD_GRAD && on) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (row[k] >= 0)
          flush_row(quad_grad + (size_t)row[k] * c4 + c, acc[k]);
    }
  }
}

// Banded K2 over one map shard's band atlas (RowBand).  It computes what
// K2 computes, restricted to the (point, plane) pairs whose cell row lies
// in the band: the band rows' quad gradient, and for every point this
// shard's part of p_grad (zero where the point owns no plane).  The bytes
// it must move are the gbar of the (point, level) pairs the band owns:
// 36 % of the mapping SDF sample's on band 1 of 2, 93 % on band 0.  K2's
// walk visits every point whatever the band owns, and on the card a
// step's instructions, not the gbar bytes, set its pace (a deeper gbar
// stream that added work per step measured slower); with the quad
// gradient, its vector reductions add their own time (one per merged
// run and lane: about 320,000 runs of 512 bytes on band 0 of the loop's
// points, as many bytes as the gbar).  This design:
//   1. Compaction inside the launch.  A block takes BANDED_CHUNK
//      consecutive points, one per thread: each thread computes its
//      point's plane coordinates (RowBand: UNOWNED outside the band) and
//      its owned-level mask (a level counts where one of its 3 planes is
//      owned).  A ballot per warp, a popcount and the scan of the warps'
//      counts in shared memory give each owned point its place in the
//      chunk's list, in point order (the loop's ray order, so a merged
//      run still merges).  A point with no owned level gets a zero p_grad
//      row there and nothing else.  No global scratch, no second launch,
//      nothing read back.
//   2. The same thread stores its listed point's per-plane scalars once,
//      which K2's lanes each recompute: the row's first element (row *
//      c4, a 32-bit offset from the lane's channels), wx - 1/2, wy - 1/2
//      and the half extents times the in-range masks.  A lane's corner
//      then costs 2 FFMAs and 2 FMULs a plane for p_grad, with no
//      predicates.
//   3. The block's warps split the list into contiguous segments and walk
//      only the listed points, and of each only its owned planes.
//   4. gbar streams through a ring of BANDED_STAGES stages in shared
//      memory per warp, filled by cp.async (16 bytes a lane, only the
//      owned levels' 512-byte slices, past L1) BANDED_STAGES - 1 points
//      ahead of the point the warp computes on.  Each lane reads back
//      only the bytes it copied, so the ring needs no barrier.  (Loading
//      the next point's gbar into registers, as K2 does, measured 2-4 %
//      faster on the card: the stream is not what holds the walk.)
//   5. Where every lane carries channels (c4 a multiple of 128, the
//      loop's case: FULL), no instruction tests the lane.
//   6. From K2: the held quad rows in registers, the float4 atomic flush
//      per merged run (a run now also spans the unlisted points between
//      two listed ones) and the transposing butterfly for p_grad.
// Shared memory, static: 33 KB at 2 levels, 47 KB at 4.
#define BANDED_WARPS 4
#define BANDED_CHUNK (BANDED_WARPS * 32)
#define BANDED_STAGES(NL) ((NL) <= 2 ? 4 : 2)
// Blocks per SM that ptxas must fit in registers: 4 (at most 128
// registers) for 1-2 levels, 2 for 3-4.
#define BANDED_MIN_BLOCKS(NL) ((NL) <= 2 ? 4 : 2)

template <int NL>
struct BandedTile {
  static constexpr int P = 3 * NL;
  static constexpr int S = BANDED_STAGES(NL);
  // Per list entry and plane: the row's first element, row * c4 (-1
  // outside the band), and (wx - 1/2, wy - 1/2, in_x * (W-1)/2,
  // in_y * (H-1)/2).
  int rows[BANDED_CHUNK][P];
  float4 frac[BANDED_CHUNK][P];
  float4 gbar[BANDED_WARPS][S][NL][32];
  int list[BANDED_CHUNK];  // (thread << 4) | owned-level mask
  int counts[BANDED_WARPS];
};

__device__ __forceinline__ void cp_async_cg16(void* smem, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int NL, bool QUAD_GRAD, bool FULL>
__global__ void __launch_bounds__(BANDED_WARPS * 32, BANDED_MIN_BLOCKS(NL))
plane_sample_bwd_banded_kernel(const float* __restrict__ gbar,
                               const float* __restrict__ p_nor,
                               const T* __restrict__ quad,
                               float* __restrict__ quad_grad,
                               float* __restrict__ p_grad, int n, int c4,
                               PlaneTable t, RowBand band) {
  constexpr int P = BandedTile<NL>::P;
  constexpr int S = BandedTile<NL>::S;
  __shared__ BandedTile<NL> sm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * BANDED_CHUNK;

  // Item 1: the chunk's list.
  const int pt = chunk + threadIdx.x;
  float4 pc[P];
  int mask = 0;
  if (pt < n) {
    point_coords<P>(p_nor, pt, t, pc, band);
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (__float_as_int(pc[k].x) >= 0) mask |= 1 << (k / 3);
    if (mask == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) p_grad[3 * (size_t)pt + a] = 0.0f;
    }
  }
  const unsigned owned = __ballot_sync(FULL_MASK, mask != 0);
  if (lane == 0) sm.counts[warp] = __popc(owned);
  __syncthreads();
  int pos = __popc(owned & ((1u << lane) - 1u));
  int len = 0;
#pragma unroll
  for (int w = 0; w < BANDED_WARPS; ++w) {
    const int cnt = sm.counts[w];
    pos += w < warp ? cnt : 0;
    len += cnt;
  }
  if (mask != 0) {  // item 2
    sm.list[pos] = (threadIdx.x << 4) | mask;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int in = __float_as_int(pc[k].w);
      const int r = __float_as_int(pc[k].x);
      sm.rows[pos][k] = r >= 0 ? r * c4 : -1;
      sm.frac[pos][k] = make_float4(
          pc[k].y - 0.5f, pc[k].z - 0.5f,
          (in & 1) ? 0.5f * ((float)t.W[k] - 1.0f) : 0.0f,
          (in & 2) ? 0.5f * ((float)t.H[k] - 1.0f) : 0.0f);
    }
  }
  __syncthreads();

  // Item 3: this warp's segment of the list.
  const int e0 = warp * len / BANDED_WARPS;
  const int e1 = (warp + 1) * len / BANDED_WARPS;
  if (e0 == e1) return;  // warp-uniform, after the block's last barrier
  const int C = c4 >> 2;
  const size_t stride = (size_t)NL * c4;
  for (int base = 0; base < c4; base += 128) {
    const int c = base + lane * 4;
    const bool on = FULL || c < c4;  // lanes past a row narrower than 128
    const int corner = c / C;
    const float sx = (corner & 1) ? 1.0f : -1.0f;
    const float sy = (corner >= 2) ? 1.0f : -1.0f;
    const float sxy = sx * sy;
    // This lane's channels of row 0: a row is 32-bit offsets away.
    const T* __restrict__ quad_c = quad + c;
    float* __restrict__ grad_c = QUAD_GRAD ? quad_grad + c : nullptr;
    // Item 4: entry e's owned gbar slices into its stage, one commit
    // group per entry (empty past the segment's end).
    auto fetch = [&](int e, int stage) {
      if (e < e1 && on) {
        const int item = sm.list[e];
        const float* src =
            gbar + (size_t)(chunk + (item >> 4)) * stride + c;
#pragma unroll
        for (int l = 0; l < NL; ++l)
          if (item & (1 << l))
            cp_async_cg16(&sm.gbar[warp][stage][l][lane], src + l * c4);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) fetch(e0 + s, s);
    int row[P];
    typename Row4<T>::V held[P];
    float acc[P][4];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      row[k] = -1;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;
    }
    for (int e = e0, stage = 0; e < e1; ++e, stage = (stage + 1) % S) {
      fetch(e + S - 1, (stage + S - 1) % S);
      cp_async_wait<S - 1>();  // entry e's group has landed
      const int item = sm.list[e];
      int r[P];
#pragma unroll
      for (int k = 0; k < P; ++k) r[k] = sm.rows[e][k];
      // An unowned plane keeps its held row and its run.
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (r[k] >= 0 && r[k] != row[k]) {  // warp-uniform
          if (QUAD_GRAD && row[k] >= 0 && on)
            flush_row(grad_c + row[k], acc[k]);
          row[k] = r[k];
          if (on) held[k] = Row4<T>::load(quad_c + r[k]);
        }
      }
      float gl[NL][4];  // an unowned level's slice is never used
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const float4 v = on ? sm.gbar[warp][stage][l][lane]
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        gl[l][0] = v.x; gl[l][1] = v.y; gl[l][2] = v.z; gl[l][3] = v.w;
      }
      float pg[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (r[k] < 0) continue;  // warp-uniform
        const float4 f = sm.frac[e][k];
        float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (on) Row4<T>::unpack(held[k], g);
        const float* gk = gl[k / 3];
        float ggl = 0.0f;  // sum_c quad[row, c] gbar[n, c] on this lane
#pragma unroll
        for (int j = 0; j < 4; ++j) ggl += g[j] * gk[j];
        // sx * fy and sy * fx, fx = 1/2 + (wx - 1/2) sx: this lane's
        // corner, folded into the plane's axes (K2's item 4).
        pg[axis_u(k % 3)] += ggl * (fmaf(f.y, sxy, 0.5f * sx) * f.z);
        pg[axis_v(k % 3)] += ggl * (fmaf(f.x, sxy, 0.5f * sy) * f.w);
        if (QUAD_GRAD) {
          const float w = fmaf(f.x, sx, 0.5f) * fmaf(f.y, sy, 0.5f);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] += gk[j] * w;
        }
      }
      store_p_grad(p_grad, chunk + (item >> 4), base, warp_sum3(pg, lane),
                   lane);
    }
    cp_async_wait<0>();  // the segment's trailing groups are empty
    if (QUAD_GRAD && on) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (row[k] >= 0) flush_row(grad_c + row[k], acc[k]);
    }
  }
}

template <typename T, int NL, bool QUAD_GRAD>
static void launch_bwd_banded(dim3 grid, cudaStream_t s, const float* gbar,
                              const float* p_nor, const T* quad,
                              float* quad_grad, float* p_grad, int n, int c4,
                              const PlaneTable& t, const RowBand& band) {
  const dim3 block(BANDED_WARPS * 32);
  if (c4 % 128 == 0)
    plane_sample_bwd_banded_kernel<T, NL, QUAD_GRAD, true>
        <<<grid, block, 0, s>>>(gbar, p_nor, quad, quad_grad, p_grad, n, c4,
                                t, band);
  else
    plane_sample_bwd_banded_kernel<T, NL, QUAD_GRAD, false>
        <<<grid, block, 0, s>>>(gbar, p_nor, quad, quad_grad, p_grad, n, c4,
                                t, band);
}

// The kernels' launches by level count: `band` null launches the
// unbanded kernels, else the banded ones.
template <typename T, int NL>
static void launch_bwd(dim3 grid, cudaStream_t s, const float* gbar,
                       const float* p_nor, const T* quad, float* quad_grad,
                       float* p_grad, int n, int c4, int run,
                       const PlaneTable& t, const RowBand* band) {
  if (band != nullptr) {
    if (quad_grad != nullptr)
      launch_bwd_banded<T, NL, true>(grid, s, gbar, p_nor, quad, quad_grad,
                                     p_grad, n, c4, t, *band);
    else
      launch_bwd_banded<T, NL, false>(grid, s, gbar, p_nor, quad, nullptr,
                                      p_grad, n, c4, t, *band);
    return;
  }
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
                              const PlaneTable& t, const RowBand* band) {
  const T* q = (const T*)quad;
  switch (n_levels) {
    case 1: launch_bwd<T, 1>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t, band); break;
    case 2: launch_bwd<T, 2>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t, band); break;
    case 3: launch_bwd<T, 3>(grid, s, gbar, p_nor, q, quad_grad, p_grad, n,
                             c4, run, t, band); break;
    default: launch_bwd<T, 4>(grid, s, gbar, p_nor, q, quad_grad, p_grad,
                              n, c4, run, t, band); break;
  }
}

template <typename T, int NL>
static void launch_fwd(dim3 grid, cudaStream_t s, const float* p_nor,
                       const T* q, float* out, int n, int c4, int run,
                       const PlaneTable& t, const RowBand* band) {
  const dim3 block(FWD_WARPS * 32);
  if (band != nullptr)
    plane_sample_fwd_banded_kernel<T, NL><<<grid, block, 0, s>>>(
        p_nor, q, out, n, c4, run, t, *band);
  else
    plane_sample_fwd_kernel<T, NL><<<grid, block, 0, s>>>(
        p_nor, q, out, n, c4, run, t);
}

template <typename T>
static void launch_fwd_levels(int n_levels, dim3 grid, cudaStream_t s,
                              const float* p_nor, const void* quad,
                              float* out, int n, int c4, int run,
                              const PlaneTable& t, const RowBand* band) {
  const T* q = (const T*)quad;
  switch (n_levels) {
    case 1: launch_fwd<T, 1>(grid, s, p_nor, q, out, n, c4, run, t, band);
      break;
    case 2: launch_fwd<T, 2>(grid, s, p_nor, q, out, n, c4, run, t, band);
      break;
    case 3: launch_fwd<T, 3>(grid, s, p_nor, q, out, n, c4, run, t, band);
      break;
    default: launch_fwd<T, 4>(grid, s, p_nor, q, out, n, c4, run, t, band);
      break;
  }
}

// Plain C interface (bound with ctypes).  `planes` is a host array of
// (H, W, row offset, u-axis, v-axis) per plane; `bands`, of the banded
// entries, a host array of (y_lo, band_h) per plane, with the row offset
// the band's in the band atlas.  Returns the launch's cudaGetLastError()
// (0 on success); outputs are written on `stream`.  `run`, `warps` and
// `blocks` are the wrapper's launch plan: warp w of the grid walks points
// [w*run, min((w+1)*run, n)), and a forward run is at most one tile;
// banded K2's `run` is the block's chunk, block b compacting points
// [b*run, min((b+1)*run, n)).  The plan must cover every point with no
// empty block.
static int fwd_entry(const float* p_nor, const void* quad, int quad_bf16,
                     float* out, int n, int c4, int n_levels,
                     const int* planes, const int* bands, int run,
                     int warps, int blocks, void* stream) {
  PlaneTable t;
  RowBand b;
  const long long per_block = (long long)warps * run;
  if (n <= 0 || c4 <= 0 || c4 % 16 != 0 ||
      !fill_table(&t, planes, n_levels) ||
      (bands != nullptr && !fill_band(&b, bands, n_levels)) ||
      warps != FWD_WARPS || run <= 0 || run > FWD_TILE || blocks <= 0 ||
      per_block * blocks < n || per_block * (blocks - 1) >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks);
  const RowBand* band = bands != nullptr ? &b : nullptr;
  if (quad_bf16)
    launch_fwd_levels<__nv_bfloat16>(n_levels, grid, s, p_nor, quad, out, n,
                                     c4, run, t, band);
  else
    launch_fwd_levels<float>(n_levels, grid, s, p_nor, quad, out, n, c4, run,
                             t, band);
  return (int)cudaGetLastError();
}

// Banded K2 addresses a row's elements by 32-bit offsets (row * c4).
static bool offsets_fit(const PlaneTable& t, const RowBand& b, int n_levels,
                        int c4) {
  for (int k = 0; k < 3 * n_levels; ++k)
    if (((long long)t.off[k] + (long long)b.band_h[k] * t.W[k]) * c4 >
        0x7fffffffLL)
      return false;
  return true;
}

static int bwd_entry(const float* gbar, const float* p_nor, const void* quad,
                     int quad_bf16, float* quad_grad, float* p_grad, int n,
                     int c4, int n_levels, const int* planes,
                     const int* bands, int run, int warps, int blocks,
                     void* stream) {
  PlaneTable t;
  RowBand b;
  const bool banded = bands != nullptr;
  const long long per_block = banded ? run : (long long)warps * run;
  if (n <= 0 || c4 <= 0 || c4 % 16 != 0 ||
      !fill_table(&t, planes, n_levels) ||
      (banded && !fill_band(&b, bands, n_levels)) ||
      warps != (banded ? BANDED_WARPS : BWD_WARPS) || run <= 0 ||
      (banded && (run != BANDED_CHUNK || !offsets_fit(t, b, n_levels, c4))) ||
      blocks <= 0 ||
      per_block * blocks < n || per_block * (blocks - 1) >= n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks);
  const RowBand* band = bands != nullptr ? &b : nullptr;
  if (quad_bf16)
    launch_bwd_levels<__nv_bfloat16>(n_levels, grid, s, gbar, p_nor, quad,
                                     quad_grad, p_grad, n, c4, run, t, band);
  else
    launch_bwd_levels<float>(n_levels, grid, s, gbar, p_nor, quad,
                             quad_grad, p_grad, n, c4, run, t, band);
  return (int)cudaGetLastError();
}

extern "C" int plane_sample_fwd(const float* p_nor, const void* quad,
                                int quad_bf16, float* out, int n, int c4,
                                int n_levels, const int* planes, int run,
                                int warps, int blocks, void* stream) {
  return fwd_entry(p_nor, quad, quad_bf16, out, n, c4, n_levels, planes,
                   nullptr, run, warps, blocks, stream);
}

extern "C" int plane_sample_fwd_banded(const float* p_nor, const void* quad,
                                       int quad_bf16, float* out, int n,
                                       int c4, int n_levels,
                                       const int* planes, const int* bands,
                                       int run, int warps, int blocks,
                                       void* stream) {
  if (bands == nullptr) return (int)cudaErrorInvalidValue;
  return fwd_entry(p_nor, quad, quad_bf16, out, n, c4, n_levels, planes,
                   bands, run, warps, blocks, stream);
}

extern "C" int plane_sample_bwd(const float* gbar, const float* p_nor,
                                const void* quad, int quad_bf16,
                                float* quad_grad, float* p_grad, int n,
                                int c4, int n_levels, const int* planes,
                                int run, int warps, int blocks,
                                void* stream) {
  return bwd_entry(gbar, p_nor, quad, quad_bf16, quad_grad, p_grad, n, c4,
                   n_levels, planes, nullptr, run, warps, blocks, stream);
}

extern "C" int plane_sample_bwd_banded(const float* gbar, const float* p_nor,
                                       const void* quad, int quad_bf16,
                                       float* quad_grad, float* p_grad,
                                       int n, int c4, int n_levels,
                                       const int* planes, const int* bands,
                                       int run, int warps, int blocks,
                                       void* stream) {
  if (bands == nullptr) return (int)cudaErrorInvalidValue;
  return bwd_entry(gbar, p_nor, quad, quad_bf16, quad_grad, p_grad, n, c4,
                   n_levels, planes, bands, run, warps, blocks, stream);
}

