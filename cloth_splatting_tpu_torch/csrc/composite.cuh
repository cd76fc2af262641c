// Shared by the tile kernels K1 and K1-span (tiled_fwd.cu), K2, K2-span, K3
// and K4 (tiled_train.cu): the per-pair classification and compositing
// update, the warp patches and footprint boxes of K1, K2, K2-span, K3 and
// K4, the two front-to-back tile walks (composite_tile_patched for K1, K2
// and K2-span, composite_tile for K1-span) and the span window of a
// multi-tile program: one block's (K1-span) or spread over a thread-block
// cluster (K2-span, K4).
//
// The packed parameter array is rows16 f32 [16, b_pad], param-major and
// tile-grouped (rows x, y, conic a/b/c, r, g, b, opacity, depth, power_cut,
// then padding). A tile's instances are columns [start, start + count); the
// walk goes over 128-instance chunks ALIGNED to the global array (the first
// is start / 128).
//
// One classification for the forward and the backward: splat_alpha below is
// the only place where a pair is found dead, so K2's compositing and K3's
// gradients can never disagree about which instances a pixel saw. The plain
// PyTorch versions (ops/rasterize/tiled_fwd.py::chunk_alpha) evaluate the
// same expression in the same order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace composite {

constexpr int kChunk = 128;
constexpr int kThreads = 256;
constexpr int kRows = 11;  // rows16[0:11] are read; 11..15 are padding
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;

// rows of rows16
constexpr int kX = 0, kY = 1, kA = 2, kB = 3, kC = 4, kR = 5, kG = 6, kBl = 7,
              kOp = 8, kDepth = 9, kCut = 10;

// Classifies one instance at one pixel offset (dx, dy) = pixel - mean.
// Returns false when the pair is dead (power > 0, power < cut, or
// alpha < 1/255); otherwise sets a_raw = op e^power and
// alpha = min(0.99, a_raw). A pair with a_raw > 0.99 is clamped: it
// composites at 0.99 and takes no xy, conic or opacity gradient.
//
// power = -0.5 (a dx^2 + c dy^2) - b dx dy is evaluated in the plain
// versions' order with every step rounded (no FMA contraction): power is
// compared against 0 and the cut, and a contracted rounding that lands a
// splat on the other side of its cut shifts the colour of a saturated pixel
// by ~1e-4 where the alpha does not move.
//
// Keep the two early returns and the test `a < kAlphaMin` as they are.
// Written as `return alpha >= kAlphaMin` (which also drops NaN), or as a
// select to 0 that the caller tests, K1 took a third longer on the 65k
// serving pack on an H100 at the same register count (the SASS was not
// inspected).
__device__ __forceinline__ bool splat_alpha(float dx, float dy, float ca,
                                            float cb, float cc, float op,
                                            float cut, float* a_raw,
                                            float* alpha) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(cb, dx), dy));
  if (power > 0.0f || power < cut) return false;
  const float raw = op * expf(power);
  const float a = fminf(kAlphaMax, raw);
  if (a < kAlphaMin) return false;
  *a_raw = raw;
  *alpha = a;
  return true;
}

// One pair's compositing update at one pixel: w = alpha T; each sum +=
// w * its channel (r, g, b, depth, 1); T *= 1 - alpha. With `live` false
// every value is selected back, so a dead pixel's T and sums keep their
// bits, signed zeros included. Both walks call it, so that the compiler
// rounds (and contracts) their accumulations alike: composite_tile with
// `live` true after its own test, composite_tile_patched with each pixel's
// classification and no branch.
__device__ __forceinline__ void composite_pair(bool live, float alpha,
                                               float cr, float cg, float cbl,
                                               float dep, float& T, float& r,
                                               float& g, float& b, float& d,
                                               float& sw) {
  const float w = alpha * T;
  const float r1 = r + w * cr;
  const float g1 = g + w * cg;
  const float b1 = b + w * cbl;
  const float d1 = d + w * dep;
  const float sw1 = sw + w;
  const float t1 = T * (1.0f - alpha);
  r = live ? r1 : r;
  g = live ? g1 : g;
  b = live ? b1 : b;
  d = live ? d1 : d;
  sw = live ? sw1 : sw;
  T = live ? t1 : T;
}

// The first of the tile's lanes in its chunk kt + ci: start's lane in the
// first chunk, 0 in every later one (start < (kt + 1) * kChunk).
//
// Do not write it as max(start - base, 0) with base = (kt + ci) * kChunk in
// int64. ptxas of CUDA 12.9 for sm_90a folds that max into one VIADDMNMX and
// can drop the negation of base, so lo becomes start + base and every tile
// whose lanes start past the first chunk composites nothing: at -O1 in K1
// and K2 for 16 px tiles, and at -O3 in K2 once the walk's exit index was
// carried in the loop variable. scripts/ptxas_check.py builds the kernels at
// -O0, -O1 and -O3 and holds each build to the plain versions.
__device__ __forceinline__ int chunk_lo(int start, int kt, int ci) {
  return ci == 0 ? start - kt * kChunk : 0;
}

// Stages chunk (kt + ci)'s 11 used rows in shared memory; the caller
// synchronises before reading them.
__device__ __forceinline__ void load_chunk(float (*sh)[kChunk],
                                           const float* __restrict__ rows16,
                                           int64_t b_pad, int64_t base) {
  for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
    const int r = e / kChunk;
    const int l = e % kChunk;
    sh[r][l] = rows16[r * b_pad + base + l];
  }
}

// One chunk's staged rows, [kRows][kChunk].
using ChunkRows = const float (*)[kChunk];

// Chunk slot `rel` of a window staged by load_span.
__device__ __forceinline__ ChunkRows span_chunk(const float* span, int rel) {
  return reinterpret_cast<ChunkRows>(span + rel * (kRows * kChunk));
}

// A program of `tpp` consecutive tiles [i0, i0 + tpp) and the window of
// `span_cap` chunks it may stage at once (the span path of K1-span, K2-span
// and K4). The tiles' segments are contiguous in the sorted array, so their
// chunks are [k0, k_end); the window starts at k0c = min(k0, C - span_cap),
// shifted down at the end of the array, and the program `fits` when the
// window holds k_end. A chunk k of a fitting program sits at slot k - k0c.
struct SpanProgram {
  int k0, k_end, k0c;
  bool fits;
};

__device__ __forceinline__ SpanProgram span_program(
    const int* __restrict__ starts, const int* __restrict__ counts, int i0,
    int tpp, int span_cap, int n_chunks_arr) {
  SpanProgram s;
  const int last = i0 + tpp - 1;
  s.k0 = starts[i0] / kChunk;
  s.k_end = (starts[last] + counts[last] + kChunk - 1) / kChunk;  // exclusive
  s.k0c = min(s.k0, n_chunks_arr - span_cap);
  s.fits = (s.k_end - s.k0c) <= span_cap;
  return s;
}

// Stages the 11 used rows of the program's chunks [k0, k_end) at their
// window slots (the window's other slots are never read); the caller
// synchronises before reading them.
__device__ __forceinline__ void load_span(float* span,
                                          const float* __restrict__ rows16,
                                          int64_t b_pad, SpanProgram s) {
  const int n = (s.k_end - s.k0) * (kRows * kChunk);
  float* dst = span + (s.k0 - s.k0c) * (kRows * kChunk);
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int c = e / (kRows * kChunk);
    const int r = (e / kChunk) % kRows;
    const int l = e % kChunk;
    dst[e] = rows16[r * b_pad + static_cast<int64_t>(s.k0 + c) * kChunk + l];
  }
}

// The pixel map of K1, K2 and K3. A tile of 16 * kQ px (PPT = kQ * kQ
// pixels a thread) is cut into 2 x 4 warp patches of 8 kQ x 4 kQ pixels, and
// a patch into 8 x 4 lane quads of kQ x kQ; pixel i of a quad is its
// row-major i-th. tiled_fwd.py::patch_pixel is its plain copy.
template <int PPT>
struct PatchMap {
  static_assert(PPT == 1 || PPT == 4, "the patched walks take 16 px and 32 px tiles");
  static constexpr int kQ = PPT == 4 ? 2 : 1;
  static constexpr int kTile = 16 * kQ;
  static constexpr int kW = 8 * kQ, kH = 4 * kQ;
  // the warp's patch and the lane's quad, in tile coordinates
  static __device__ __forceinline__ int patch_x(int warp) {
    return (warp & 1) * kW;
  }
  static __device__ __forceinline__ int patch_y(int warp) {
    return (warp >> 1) * kH;
  }
  static __device__ __forceinline__ int quad_x(int warp, int lane) {
    return patch_x(warp) + (lane & 7) * kQ;
  }
  static __device__ __forceinline__ int quad_y(int warp, int lane) {
    return patch_y(warp) + (lane >> 3) * kQ;
  }
};

template <int PPT>
__device__ __forceinline__ int patch_pixel(int warp, int lane, int i) {
  using M = PatchMap<PPT>;
  return (M::quad_y(warp, lane) + i / M::kQ) * M::kTile + M::quad_x(warp, lane) +
         i % M::kQ;
}

// The footprint box's margins (tiled_fwd.py holds the same literals).
// The box bounds {power >= tau} under the exact quadratic form of the conic
// with ac scaled by kCullDetScale in its determinant, which covers the
// kernel's rounded form (off by a few ulp of a dx^2 + c dy^2, i.e. a conic
// shrunk by ~1e-6) and the determinant's own rounding; it is then widened
// by kCullWiden, kCullAbs px and kCullMeanRel of |mean| (sqrt and division,
// the rounding of dx and of the mean plus the half-width). tau is lowered
// by kCullLogMargin for expf, logf and the rounding of op e^power against
// 1/255 (each a few ulp).
constexpr float kCullLogMargin = 1e-3f;
constexpr float kCullDetScale = 0.99998f;
constexpr float kCullWiden = 1.001f;
constexpr float kCullAbs = 1e-2f;
constexpr float kCullMeanRel = 1e-6f;

// A box (x_lo, x_hi, y_lo, y_hi) in pixel coordinates that holds every
// pixel at which splat_alpha can find this instance alive; plain copy:
// tiled_fwd.py::footprint_boxes. A live pair has cut <= power <= 0 and
// op e^power >= 1/255 (min(0.99, raw) >= 1/255 iff raw >= 1/255), so
// power >= tau = max(cut, log(1 / (255 op))). For a positive definite
// conic [[a, b], [b, c]] with det = ac - b^2, the offsets with power >= tau
// lie in |dx| <= sqrt(-2 tau c / det), |dy| <= sqrt(-2 tau a / det). An
// instance whose conic is not positive definite, or whose determinant or
// box is not finite, gets the whole plane.
__device__ __forceinline__ float4 footprint_box(float x, float y, float a,
                                                float b, float c, float op,
                                                float cut) {
  const float tau = fmaxf(cut, -logf(255.0f * op) - kCullLogMargin);
  const float r2 = tau >= 0.0f ? 0.0f : -2.0f * tau;  // NaN stays NaN
  const float det = a * c * kCullDetScale - b * b;
  const float rx = sqrtf(r2 * c / det) * kCullWiden + kCullAbs +
                   kCullMeanRel * fabsf(x);
  const float ry = sqrtf(r2 * a / det) * kCullWiden + kCullAbs +
                   kCullMeanRel * fabsf(y);
  const float inf = __int_as_float(0x7f800000);
  // NaN fails every comparison, so `< inf` also tests for NaN
  if (a > 0.0f && det > 0.0f && det < inf && fabsf(x) + rx < inf &&
      fabsf(y) + ry < inf)
    return make_float4(x - rx, x + rx, y - ry, y + ry);
  return make_float4(-inf, inf, -inf, inf);
}

// Stages chunk `base`'s 11 rows in sh and each instance's footprint box in
// boxes: thread j < 128 owns instance j. The caller synchronises.
__device__ __forceinline__ void load_chunk_boxes(
    float (*sh)[kChunk], float4* boxes, const float* __restrict__ rows16,
    int64_t b_pad, int64_t base) {
  const int j = threadIdx.x;
  if (j >= kChunk) return;
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    v[r] = rows16[r * b_pad + base + j];
    sh[r][j] = v[r];
  }
  boxes[j] = footprint_box(v[kX], v[kY], v[kA], v[kB], v[kC], v[kOp], v[kCut]);
}

// Where a patched walk takes a chunk's rows from: GlobalStage stages chunk
// `base` from rows16 (K1, K2 and a span program that does not fit its
// window); WindowStage (below) copies it from the cluster's window.
struct GlobalStage {
  __device__ __forceinline__ void operator()(float (*sh)[kChunk], float4* boxes,
                                             const float* __restrict__ rows16,
                                             int64_t b_pad, int64_t base) const {
    load_chunk_boxes(sh, boxes, rows16, b_pad, base);
  }
};

// The forward walk of K1, K2 and K2-span, one tile per 256-thread block: for
// every pixel
//   w = alpha T;  T *= 1 - alpha;  sum w * (r, g, b, depth, 1)
// over the tile's live instances in order, stopping after the first chunk
// at which max over the tile's pixels of T is <= 1e-4 (a tile-wide vote).
// Writes out [n_tiles, 8, p]: r, g, b + bg (1 - sum w), depth, alpha =
// sum w, then three zero rows. kRecord (K2) also stores every pixel's T at
// the start of each chunk it walks to tb[(offset + ci) * p + pixel], and
// zeros for the tile's chunks after the exit, so "never started" reads as
// "max boundary is 0". Both are pixel-index-major, as K3 and K4 read them.
//
// It walks as K3 does, where composite_tile (the span forms' walk) has
// every warp classify every instance of the tile on all its pixels:
//   - warp w owns a compact patch of the tile and each lane a quad of it
//     (patch_pixel);
//   - when a chunk is staged, each instance also gets its footprint box; a
//     warp tests its patch against the 128 boxes with 4 ballots and walks
//     only the instances that hit it, in ascending lane order. A skipped
//     instance is dead at every pixel of the warp, where composite_tile
//     changes no T or sum, so every pixel goes through the same float
//     operations in the same order as there (chip_smoke holds the span
//     forms bit-identical to K1 and K2);
//   - a lane classifies its pixels first and then runs composite_pair on
//     each, a dead pixel selected back, without a branch per pixel; a warp
//     none of whose pixels sees the instance skips the update.
// `stage` puts each chunk's rows and boxes in sh and boxes; where they come
// from changes no bit of the result (K2-span is held bit-identical to K2).
template <int PPT, bool kRecord, typename Stage = GlobalStage>
__device__ __forceinline__ void composite_tile_patched(
    int tile, const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    float* __restrict__ out, float* __restrict__ tb, int tw, int64_t b_pad,
    float bg0, float bg1, float bg2, float (*sh)[kChunk], float4* boxes,
    Stage stage = Stage{}) {
  using M = PatchMap<PPT>;
  constexpr int kQ = M::kQ;
  constexpr int p = M::kTile * M::kTile;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* tb_tile = nullptr;
  if (kRecord) tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;

  // the lane's quad (pixel i at column i % kQ, row i / kQ) and the warp's
  // patch, in pixel coordinates
  const int ox = (tile % tw) * M::kTile;
  const int oy = (tile / tw) * M::kTile;
  float qx[kQ], qy[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    qx[k] = static_cast<float>(ox + M::quad_x(warp, lane) + k);
    qy[k] = static_cast<float>(oy + M::quad_y(warp, lane) + k);
  }
  const float patch_x0 = static_cast<float>(ox + M::patch_x(warp));
  const float patch_x1 = patch_x0 + static_cast<float>(M::kW - 1);
  const float patch_y0 = static_cast<float>(oy + M::patch_y(warp));
  const float patch_y1 = patch_y0 + static_cast<float>(M::kH - 1);

  float T[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_d[PPT], acc_w[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    T[i] = 1.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = acc_d[i] = acc_w[i] = 0.0f;
  }

  // chunks walked, fewer when the exit fires
  int walked = n_chunks;
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (kRecord) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        tb_tile[static_cast<int64_t>(ci) * p + patch_pixel<PPT>(warp, lane, i)] =
            T[i];
    }
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    stage(sh, boxes, rows16, b_pad, base);
    __syncthreads();

    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    // the chunk's live instances whose box meets the warp's patch, 32 at a
    // time, each word's in ascending lane order
#pragma unroll 1
    for (int k = 0; k < kChunk / 32; ++k) {
      const int jl = k * 32 + lane;
      const float4 bx = boxes[jl];
      unsigned m = __ballot_sync(0xffffffffu, jl >= lo && jl < hi &&
                                                  bx.x <= patch_x1 && bx.y >= patch_x0 &&
                                                  bx.z <= patch_y1 && bx.w >= patch_y0);
      while (m != 0u) {
        const int j = k * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const float gx = sh[kX][j], gy = sh[kY][j];
        const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
        const float op = sh[kOp][j], cut = sh[kCut][j];
        bool live[PPT];
        float alpha[PPT];
        bool seen = false;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          float a_raw = 0.0f;
          alpha[i] = 0.0f;
          live[i] = splat_alpha(qx[i % kQ] - gx, qy[i / kQ] - gy, ca, cb, cc,
                                op, cut, &a_raw, &alpha[i]);
          seen |= live[i];
        }
        if (!__any_sync(0xffffffffu, seen)) continue;
        const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
        const float dep = sh[kDepth][j];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          composite_pair(live[i], alpha[i], cr, cg, cbl, dep, T[i], acc_r[i],
                         acc_g[i], acc_b[i], acc_d[i], acc_w[i]);
      }
    }

    float t_max = 0.0f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) t_max = fmaxf(t_max, T[i]);
    // barrier (the next chunk overwrites sh and boxes) and the tile-wide
    // exit vote
    if (!__syncthreads_or(t_max > kTransEps)) {
      walked = ci + 1;
      break;
    }
  }
  if (kRecord) {
    for (int ci = walked; ci < n_chunks; ++ci) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        tb_tile[static_cast<int64_t>(ci) * p + patch_pixel<PPT>(warp, lane, i)] =
            0.0f;
    }
  }

  float* o = out + static_cast<int64_t>(tile) * 8 * p;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = patch_pixel<PPT>(warp, lane, i);
    const float t_final = 1.0f - acc_w[i];
    o[0 * p + pix] = acc_r[i] + t_final * bg0;
    o[1 * p + pix] = acc_g[i] + t_final * bg1;
    o[2 * p + pix] = acc_b[i] + t_final * bg2;
    o[3 * p + pix] = acc_d[i];
    o[4 * p + pix] = acc_w[i];
    o[5 * p + pix] = 0.0f;
    o[6 * p + pix] = 0.0f;
    o[7 * p + pix] = 0.0f;
  }
}

// K1-span's walk of one tile (one 256-thread block, PPT pixels per thread;
// tile_size^2 == PPT * 256): the function of composite_tile_patched, with
// its outputs, walked as the kernels were first written. Thread t owns
// pixels t + i * 256, so every warp classifies every instance of the tile on
// all its pixels. It is kept as the yardstick of the patched walk:
// chip_smoke holds K1-span bit-identical to K1, and K2's output to
// K1-span's.
//
// Where a chunk's rows come from is the only difference between its two
// forms: with kSpan false each chunk is staged in `sh` (load_chunk) before
// it is walked (a span program that does not fit its window); with kSpan
// true the chunk kt + ci is read at slot kt + ci - k0c of `span`, which the
// block staged once.
//
// kRecord records the boundaries as composite_tile_patched does; no kernel
// takes it (K2-span runs the patched walk).
//
// A block may walk several tiles one after another: every chunk ends in a
// barrier (the vote), so no thread still reads `sh` when the next tile's
// first chunk is staged, and a tile keeps nothing else in shared memory.
template <int PPT, bool kRecord, bool kSpan>
__device__ __forceinline__ void composite_tile(
    int tile, const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    float* __restrict__ out, float* __restrict__ tb, int tw, int64_t b_pad,
    int tile_size, float bg0, float bg1, float bg2, float (*sh)[kChunk],
    const float* span, int k0c) {
  const int p = tile_size * tile_size;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const int ox = (tile % tw) * tile_size;
  const int oy = (tile / tw) * tile_size;
  float* tb_tile = nullptr;
  if (kRecord) tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;

  float px[PPT], py[PPT], T[PPT];
  float acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_d[PPT], acc_w[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    px[i] = static_cast<float>(ox + pix % tile_size);
    py[i] = static_cast<float>(oy + pix / tile_size);
    T[i] = 1.0f;
    acc_r[i] = acc_g[i] = acc_b[i] = acc_d[i] = acc_w[i] = 0.0f;
  }

  // chunks walked, fewer when the exit fires
  int walked = n_chunks;
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (kRecord) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        tb_tile[static_cast<int64_t>(ci) * p + threadIdx.x + i * kThreads] = T[i];
    }
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    ChunkRows rows;
    if (kSpan) {
      rows = span_chunk(span, kt - k0c + ci);
    } else {
      load_chunk(sh, rows16, b_pad, base);
      __syncthreads();
      rows = const_cast<ChunkRows>(sh);
    }

    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    for (int j = lo; j < hi; ++j) {
      const float gx = rows[kX][j], gy = rows[kY][j];
      const float ca = rows[kA][j], cb = rows[kB][j], cc = rows[kC][j];
      const float cr = rows[kR][j], cg = rows[kG][j], cbl = rows[kBl][j];
      const float op = rows[kOp][j], dep = rows[kDepth][j], cut = rows[kCut][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float a_raw, alpha;
        if (!splat_alpha(px[i] - gx, py[i] - gy, ca, cb, cc, op, cut, &a_raw,
                         &alpha))
          continue;
        composite_pair(true, alpha, cr, cg, cbl, dep, T[i], acc_r[i], acc_g[i],
                       acc_b[i], acc_d[i], acc_w[i]);
      }
    }

    float t_max = 0.0f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) t_max = fmaxf(t_max, T[i]);
    // barrier (the next chunk overwrites sh) and the tile-wide exit vote
    if (!__syncthreads_or(t_max > kTransEps)) {
      walked = ci + 1;
      break;
    }
  }
  if (kRecord) {
    for (int ci = walked; ci < n_chunks; ++ci) {
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        tb_tile[static_cast<int64_t>(ci) * p + threadIdx.x + i * kThreads] = 0.0f;
    }
  }

  float* o = out + static_cast<int64_t>(tile) * 8 * p;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    const float t_final = 1.0f - acc_w[i];
    o[0 * p + pix] = acc_r[i] + t_final * bg0;
    o[1 * p + pix] = acc_g[i] + t_final * bg1;
    o[2 * p + pix] = acc_b[i] + t_final * bg2;
    o[3 * p + pix] = acc_d[i];
    o[4 * p + pix] = acc_w[i];
    o[5 * p + pix] = 0.0f;
    o[6 * p + pix] = 0.0f;
    o[7 * p + pix] = 0.0f;
  }
}

// Says at compile time which walk a tile of a program takes.
template <bool kSpan>
struct SpanTag {
  static constexpr bool value = kSpan;
};

// One program of K1-span: `tpp` consecutive tiles per block. When the
// tiles' chunks fit the window, the block stages them once in `span`
// (dynamic shared memory, span_cap chunks) and calls tile_fn(tile,
// SpanTag<true>, nullptr, span, k0c) for each tile; otherwise every tile
// takes the per-chunk walk, tile_fn(tile, SpanTag<false>, sh, nullptr, 0),
// staging each chunk in the window's first slot `sh`. `fits` is uniform
// over the block, so the barriers inside the walks are too.
template <typename TileFn>
__device__ __forceinline__ void for_each_tile_of_program(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows16, int64_t b_pad, int tpp, int span_cap,
    float* span, TileFn tile_fn) {
  const int i0 = blockIdx.x * tpp;
  const SpanProgram s = span_program(starts, counts, i0, tpp, span_cap,
                                     static_cast<int>(b_pad / kChunk));
  if (s.fits) {
    load_span(span, rows16, b_pad, s);
    __syncthreads();
    for (int t = 0; t < tpp; ++t)
      tile_fn(i0 + t, SpanTag<true>{}, nullptr, span, s.k0c);
  } else {
    float (*sh)[kChunk] = reinterpret_cast<float (*)[kChunk]>(span);
    for (int t = 0; t < tpp; ++t)
      tile_fn(i0 + t, SpanTag<false>{}, sh, nullptr, 0);
  }
}

// One program of K1-span (kRecord false).
template <int PPT, bool kRecord>
__device__ __forceinline__ void composite_program(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    float* __restrict__ out, float* __restrict__ tb, int tw, int64_t b_pad,
    int tile_size, float bg0, float bg1, float bg2, int tpp, int span_cap,
    float* span) {
  for_each_tile_of_program(
      starts, counts, rows16, b_pad, tpp, span_cap, span,
      [&](int tile, auto in_span, float (*sh)[kChunk], const float* window,
          int k0c) {
        composite_tile<PPT, kRecord, decltype(in_span)::value>(
            tile, starts, counts, offsets, rows16, out, tb, tw, b_pad,
            tile_size, bg0, bg1, bg2, sh, window, k0c);
      });
}

// Launches K1-span on `stream`: n_tiles / tpp blocks with a window of
// span_cap chunks of dynamic shared memory, which the kernel must opt in to
// above 48 KB. `args` are the kernel's parameters before (tpp, span_cap).
// Returns the CUDA error of the attribute call or of the launch.
template <typename... Params, typename... Args>
int launch_span(void (*kernel)(Params...), int n_tiles, int tpp, int span_cap,
                cudaStream_t stream, Args... args) {
  const size_t smem =
      static_cast<size_t>(span_cap) * kRows * kChunk * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles / tpp, kThreads, smem, stream>>>(args..., tpp, span_cap);
  return static_cast<int>(cudaGetLastError());
}

// Whether (tpp, span_cap) are arguments a span kernel can be launched with.
inline bool span_args_ok(int n_tiles, int64_t b_pad, int tpp, int span_cap) {
  return tpp >= 1 && n_tiles % tpp == 0 && span_cap >= 1 &&
         span_cap <= b_pad / kChunk;
}

// ---------------------------------------------------------------------------
// The cluster program of K2-span and K4: one CTA per tile, a program of `tpp`
// tiles run by tpp / c thread-block clusters of c CTAs, and the program's
// window spread over the cluster's shared memory.
//
// The JAX kernels (pallas_train.py, one_tile_vmem) give a program of tpp
// consecutive tiles to one grid step, which fetches the chunks [k0, k_end)
// of all its tiles into VMEM once when they fit span_cap chunks and walks
// the tiles one after another. On the H100 a whole window in one block's
// shared memory (41 chunks, 231 KB) leaves one 8-warp block an SM, and a
// block per program gives 125 blocks at 800x800 for 132 SMs (K1-span's
// layout, for_each_tile_of_program). Here CTA r of a cluster walks tile
// i0 + r alone, so every tile of a program is in flight at once (625 CTAs
// at 32 px), and each CTA holds only its share of the window: chunk
// a + r + q c at its slot q,
// ceil(span_cap / c) slots at most, where [a, b) are the chunks of the
// cluster's own tiles (the whole program's [k0, k_end) when c == tpp).
// Each CTA fetches its share with cp.async.bulk (11 rows of 512 B a chunk,
// completing on an mbarrier); after a cluster barrier, a CTA copies each
// chunk it walks from the owner's slot into its own sh and boxes through
// distributed shared memory; a last cluster barrier keeps every CTA resident
// until no other CTA reads its slots. A chunk that two tiles of a cluster
// share is read from device memory once, as the span means. When c < tpp
// (a tpp above 8, which no path of the repo drives), each cluster stages the
// part of the window its own tiles cover, so a chunk at the seam of two
// clusters is read once by each.
//
// `fits` is decided per program, as span_program does, so every CTA of a
// cluster takes the same branch; a program that does not fit walks each
// tile staging chunk by chunk from rows16 (the counterpart of one_tile_dma)
// and takes no cluster barrier. No atomics: every slot of the outputs
// belongs to one tile.

// CTAs in a cluster for `tpp` tiles a program: tpp itself up to 8, the
// portable limit, else its largest divisor <= 8 (tiled_fwd.py's
// span_cluster_size is the plain copy).
__host__ __device__ __forceinline__ int span_cluster_size(int tpp) {
  for (int c = tpp < 8 ? tpp : 8; c > 1; --c)
    if (tpp % c == 0) return c;
  return 1;
}

// Chunk slots a CTA of a cluster of c holds for a window of span_cap chunks.
__host__ __device__ __forceinline__ int window_slots(int span_cap, int c) {
  return (span_cap + c - 1) / c;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stages this CTA's share of the cluster's chunks [a, b), chunk a + rank +
// q c at slot q of `window`, with one thread issuing a bulk copy per row and
// every thread waiting on the mbarrier `bar` until the bytes have landed.
__device__ __forceinline__ void stage_window_share(
    float* window, uint64_t* bar, const float* __restrict__ rows16,
    int64_t b_pad, int a, int b, int c, int rank) {
  const uint32_t bar_a = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = b - a > rank ? (b - a - rank + c - 1) / c : 0;
    const uint32_t row_bytes = kChunk * sizeof(float);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_a),
                 "r"(static_cast<uint32_t>(n * kRows) * row_bytes)
                 : "memory");
    for (int q = 0; q < n; ++q) {
      const int64_t k = a + rank + q * c;
      for (int r = 0; r < kRows; ++r) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];" ::"r"(smem_u32(window + (q * kRows + r) * kChunk)),
            "l"(rows16 + r * b_pad + k * kChunk), "r"(row_bytes), "r"(bar_a)
            : "memory");
      }
    }
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar_a)
        : "memory");
  }
}

// Copies chunk `base` of the cluster's window from its owner's slot into sh
// and computes its boxes, as load_chunk_boxes does from rows16: thread j <
// 128 owns instance j. The caller synchronises.
struct WindowStage {
  const float* window;  // this CTA's slots (a local shared address)
  int a, c;             // the cluster's first chunk and size
  __device__ __forceinline__ void operator()(float (*sh)[kChunk], float4* boxes,
                                             const float* __restrict__,
                                             int64_t, int64_t base) const {
    const int j = threadIdx.x;
    if (j >= kChunk) return;
    const int rel = static_cast<int>(base / kChunk) - a;
    const float* src = cooperative_groups::this_cluster().map_shared_rank(
        window + (rel / c) * (kRows * kChunk), rel % c);
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[r] = src[r * kChunk + j];
      sh[r][j] = v[r];
    }
    boxes[j] = footprint_box(v[kX], v[kY], v[kA], v[kB], v[kC], v[kOp], v[kCut]);
  }
};

// Runs this CTA's tile of its span program: tile_fn(tile, stage) with a
// WindowStage when the program fits its window, between the two cluster
// barriers, else with a GlobalStage. `window` is the CTA's dynamic shared
// memory (window_slots chunk slots), `bar` an mbarrier in shared memory.
template <typename TileFn>
__device__ __forceinline__ void run_cluster_program(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows16, int64_t b_pad, int tpp, int span_cap,
    float* window, uint64_t* bar, TileFn tile_fn) {
  const int tile = blockIdx.x;
  const SpanProgram s = span_program(starts, counts, tile - tile % tpp, tpp,
                                     span_cap, static_cast<int>(b_pad / kChunk));
  if (!s.fits) {
    tile_fn(tile, GlobalStage{});
    return;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int first = tile - rank, last = first + c - 1;
  const int a = starts[first] / kChunk;
  const int b = (starts[last] + counts[last] + kChunk - 1) / kChunk;
  stage_window_share(window, bar, rows16, b_pad, a, b, c, rank);
  cluster.sync();  // every share staged and visible to the cluster
  tile_fn(tile, WindowStage{window, a, c});
  cluster.sync();  // no CTA leaves while another reads its slots
}

// The launch configuration of K2-span or K4: n_tiles CTAs in clusters of
// span_cluster_size(tpp) (set in *attr), window_slots(span_cap, c) chunk
// slots of dynamic shared memory each.
inline cudaLaunchConfig_t cluster_config(int n_tiles, int tpp, int span_cap,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  const int c = span_cluster_size(tpp);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(window_slots(span_cap, c)) * kRows * kChunk * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster launch of K2-span or K4 on `stream`. `args` are the kernel's
// parameters before (tpp, span_cap). Returns the CUDA error of the
// attribute call or of the launch: a refused cluster launch is an error,
// not a fallback.
template <typename... Params, typename... Args>
int launch_span_cluster(void (*kernel)(Params...), int n_tiles, int tpp,
                        int span_cap, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_tiles, tpp, span_cap, stream, &attr);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, args..., tpp, span_cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the occupancy calculator says of a cluster launch: out[0] blocks an
// SM (registers and shared memory), out[1] clusters resident on the card at
// once, out[2] the cluster size. Returns the CUDA error.
template <typename... Params>
int span_cluster_occupancy(void (*kernel)(Params...), int n_tiles, int tpp,
                           int span_cap, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n_tiles, tpp, span_cap, 0, &attr);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.dynamicSmemBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, kThreads,
                                                        cfg.dynamicSmemBytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&out[1], fn, &cfg);
  out[2] = attr.val.clusterDim.x;
  return static_cast<int>(err);
}

// Whether a cluster launch can take rows16: cp.async.bulk needs 16 B
// aligned addresses and sizes, which every row of every chunk then has
// (b_pad is a multiple of 128 floats).
inline bool bulk_rows_ok(const void* rows16, int64_t b_pad) {
  return reinterpret_cast<uintptr_t>(rows16) % 16 == 0 && b_pad % kChunk == 0;
}

}  // namespace composite
