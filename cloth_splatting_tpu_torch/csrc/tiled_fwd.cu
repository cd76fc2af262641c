// K1 and K1-span: per-tile front-to-back alpha compositor for the serving
// rasterizer.
//
// K1 replaces the TPU kernel cloth_splatting_tpu/ops/rasterize/
// pallas_tiled.py::_kernel (tile walk _one_tile, per-chunk math
// _composite_chunk); K1-span replaces the same kernel's span branch
// (tiles_per_program > 1 with span_cap > 0, _one_tile_vmem). Python wrapper
// and plain PyTorch version: ops/rasterize/tiled_fwd.py
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
// alpha = sum w, then three zero rows. The walk itself is
// composite.cuh::composite_tile, shared with K2.
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
//
// K1-span gives one block `tpp` consecutive tiles. Their instances are one
// contiguous run of the sorted array, so when the run's chunks fit a window
// of span_cap chunks the block stages them once in dynamic shared memory
// (5,632 bytes a chunk, at most 41 chunks under the 227 KB a block may opt
// in to) and composites its tiles one after another from there; a program
// that does not fit walks chunk by chunk as K1 does. The walk is the same
// function either way, so the values are K1's. It trades blocks in flight
// (n_tiles / tpp) and occupancy (one block per SM at a large window) for
// one fetch per program; whether that pays on this card is measured, not
// assumed.

#include "composite.cuh"

namespace {

using composite::kChunk;
using composite::kRows;
using composite::kThreads;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                 const float* __restrict__ rows16, float* __restrict__ out,
                 int tw, int64_t b_pad, int tile_size, float bg0, float bg1,
                 float bg2) {
  __shared__ float sh[kRows][kChunk];
  composite::composite_tile<PPT, false, false>(
      blockIdx.x, starts, counts, nullptr, rows16, out, nullptr, tw, b_pad,
      tile_size, bg0, bg1, bg2, sh, nullptr, 0);
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_span_kernel(const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ rows16, float* __restrict__ out,
                      int tw, int64_t b_pad, int tile_size, float bg0,
                      float bg1, float bg2, int tpp, int span_cap) {
  extern __shared__ float span[];
  composite::composite_program<PPT, false>(starts, counts, nullptr, rows16, out,
                                           nullptr, tw, b_pad, tile_size, bg0,
                                           bg1, bg2, tpp, span_cap, span);
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

// Launches K1-span on `stream`: as tiled_fwd_launch, with n_tiles / tpp
// blocks of tpp tiles and a window of span_cap chunks (1 <= span_cap <=
// b_pad / 128, tpp dividing n_tiles; the window's bytes must fit a block's
// shared memory). Returns the CUDA error of the attribute call or of the
// launch (cudaErrorInvalidValue for unsupported arguments).
extern "C" int tiled_fwd_span_launch(const void* starts, const void* counts,
                                     const void* rows16, void* out, int n_tiles,
                                     int tw, int64_t b_pad, int tile_size,
                                     float bg0, float bg1, float bg2, int tpp,
                                     int span_cap, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const float* rows = static_cast<const float*>(rows16);
  float* o = static_cast<float*>(out);
  if (tile_size == 32)
    return composite::launch_span(tiled_fwd_span_kernel<4>, n_tiles, tpp,
                                  span_cap, s, st, ct, rows, o, tw, b_pad,
                                  tile_size, bg0, bg1, bg2);
  if (tile_size == 16)
    return composite::launch_span(tiled_fwd_span_kernel<1>, n_tiles, tpp,
                                  span_cap, s, st, ct, rows, o, tw, b_pad,
                                  tile_size, bg0, bg1, bg2);
  return static_cast<int>(cudaErrorInvalidValue);
}
