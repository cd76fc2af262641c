// Shared by the tile kernels K1 (tiled_fwd.cu), K2 and K3 (tiled_train.cu):
// the per-pair classification and the front-to-back tile walk.
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

// The forward walk of one tile (one 256-thread block, PPT pixels per
// thread; tile_size^2 == PPT * 256): for every pixel
//   w = alpha T;  T *= 1 - alpha;  sum w * (r, g, b, depth, 1)
// over the tile's live instances in order, stopping after the first chunk
// at which max over the tile's pixels of T is <= 1e-4 (a tile-wide vote).
// Writes out [n_tiles, 8, p]: r, g, b + bg (1 - sum w), depth, alpha =
// sum w, then three zero rows.
//
// kRecord (K2) also stores every pixel's T at the start of each chunk it
// walks to tb[(offset + ci) * p + pixel], and zeros for the tile's chunks
// after the exit, so "never started" reads as "max boundary is 0".
template <int PPT, bool kRecord>
__device__ __forceinline__ void composite_tile(
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    float* __restrict__ out, float* __restrict__ tb, int tw, int64_t b_pad,
    int tile_size, float bg0, float bg1, float bg2) {
  __shared__ float sh[kRows][kChunk];

  const int tile = blockIdx.x;
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
    load_chunk(sh, rows16, b_pad, base);
    __syncthreads();

    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    for (int j = lo; j < hi; ++j) {
      const float gx = sh[kX][j], gy = sh[kY][j];
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
      const float op = sh[kOp][j], dep = sh[kDepth][j], cut = sh[kCut][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float a_raw, alpha;
        if (!splat_alpha(px[i] - gx, py[i] - gy, ca, cb, cc, op, cut, &a_raw,
                         &alpha))
          continue;
        const float w = alpha * T[i];
        acc_r[i] += w * cr;
        acc_g[i] += w * cg;
        acc_b[i] += w * cbl;
        acc_d[i] += w * dep;
        acc_w[i] += w;
        T[i] *= 1.0f - alpha;
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

}  // namespace composite
