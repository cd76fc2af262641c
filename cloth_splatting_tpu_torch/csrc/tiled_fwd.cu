// K1: per-tile front-to-back alpha compositor for the serving rasterizer.
//
// Replaces the TPU kernel cloth_splatting_tpu/ops/rasterize/pallas_tiled.py
// ::_kernel (tile walk _one_tile, per-chunk math _composite_chunk). Python
// wrapper and plain PyTorch version: ops/rasterize/tiled_fwd.py
// (raster_forward_tiles, raster_forward_tiles_plain).
//
// What it computes, per tile of tile_size^2 pixels: the tile's instances are
// rows16[:, start : start + count] of the globally sorted, tile-grouped,
// front-to-back parameter array [16, b_pad] (rows x, y, conic a/b/c, r, g, b,
// opacity, depth, power_cut). The walk goes over 128-instance chunks ALIGNED
// to the global array (the first is start / 128) and, for every pixel,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(0.99, opacity e^power), zero if power > 0, power < cut or
//           alpha < 1/255
//   w = alpha T;  T *= 1 - alpha;  sum w * (r, g, b, depth, 1)
// and stops after the first chunk at which max over the tile's pixels of T
// is <= 1e-4 (a tile-wide vote, not a per-pixel exit, to match the TPU
// kernel). Output [n_tiles, 8, p]: r, g, b + bg (1 - sum w), depth,
// alpha = sum w, then three zero rows.
//
// What bounds it on the H100: fp32 arithmetic. Each live instance-pixel pair
// costs ~27 fp32 operations and one expf, while the bytes moved are the 11
// used rows per walked instance plus the 32 bytes written per pixel (tens of
// MB per 800x800 frame, a few microseconds at 3.35 TB/s).
//
// What the design does about it: one 256-thread block per tile, each thread
// owning p / 256 pixels (4 at 32 px tiles, 1 at 16 px), their T and sums in
// registers. A chunk's 11 rows are staged in shared memory (5.5 KB); all
// threads then read the same instance at once (a shared-memory broadcast)
// and only the chunk's live lanes [start, start + count) are walked. The
// pixels of one thread are independent chains, which gives the FMA pipes
// instruction-level parallelism. No tensor cores, TMA or double buffering
// yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;
constexpr int kThreads = 256;
constexpr int kRows = 11;  // rows16[0:11] are read; 11..15 are padding
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTransEps = 1e-4f;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                 const float* __restrict__ rows16, float* __restrict__ out,
                 int tw, int64_t b_pad, int tile_size, float bg0, float bg1,
                 float bg2) {
  __shared__ float sh[kRows][kChunk];

  const int tile = blockIdx.x;
  const int p = tile_size * tile_size;  // == PPT * kThreads
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const int ox = (tile % tw) * tile_size;
  const int oy = (tile / tw) * tile_size;

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

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    for (int e = threadIdx.x; e < kRows * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int l = e % kChunk;
      sh[r][l] = rows16[r * b_pad + base + l];
    }
    __syncthreads();

    const int lo = max(static_cast<int>(start - base), 0);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    for (int j = lo; j < hi; ++j) {
      const float gx = sh[0][j], gy = sh[1][j];
      const float ca = sh[2][j], cb = sh[3][j], cc = sh[4][j];
      const float cr = sh[5][j], cg = sh[6][j], cbl = sh[7][j];
      const float op = sh[8][j], dep = sh[9][j], cut = sh[10][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = px[i] - gx;
        const float dy = py[i] - gy;
        // -0.5 (a dx^2 + c dy^2) - b dx dy in the plain version's order with
        // every step rounded (no FMA contraction): power is compared against
        // 0 and the cut, and a contracted rounding that lands a splat on the
        // other side of its cut shifts the colour of a saturated pixel by
        // ~1e-4 where the alpha does not move.
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        if (power > 0.0f || power < cut) continue;
        const float alpha = fminf(kAlphaMax, op * expf(power));
        if (alpha < kAlphaMin) continue;
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
    if (!__syncthreads_or(t_max > kTransEps)) break;
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

}  // namespace

// Launches K1 on `stream`. Pointers are device pointers to contiguous
// starts/counts i32 [n_tiles], rows16 f32 [16, b_pad] and out f32
// [n_tiles, 8, tile_size^2]. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported tile_size).
extern "C" int tiled_fwd_launch(const void* starts, const void* counts,
                                const void* rows16, void* out, int n_tiles,
                                int tw, int64_t b_pad, int tile_size, float bg0,
                                float bg1, float bg2, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const float* rows = static_cast<const float*>(rows16);
  float* o = static_cast<float*>(out);
  if (tile_size == 32) {
    tiled_fwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(st, ct, rows, o, tw, b_pad,
                                                     tile_size, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_fwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(st, ct, rows, o, tw, b_pad,
                                                     tile_size, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
