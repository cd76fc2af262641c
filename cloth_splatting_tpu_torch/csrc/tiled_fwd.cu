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
// composite.cuh::composite_tile_patched, shared with K2, K1-span and K2-span.
//
// What bounds it on the H100. Its function is bound by bytes: the 11 used
// rows per walked instance and 20 bytes written per pixel, a few
// microseconds at 3.35 TB/s, against ~27 fp32 operations per pair that
// contributes. The kernel's time goes to finding those pairs: on the 65k
// packs ~97% of the walked instance-pixel pairs are dead, and the first
// form classified every one of them (every warp saw every instance of the
// tile), so it was bound by issuing that classification.
//
// What the design does about it: one 256-thread block per tile, each thread
// owning p / 256 pixels (a 2 x 2 quad at 32 px tiles, one pixel at 16 px) of
// its warp's compact patch, their T and sums in registers. A chunk's 11 rows
// and each instance's footprint box are staged in shared memory (7.5 KB);
// each warp walks only the live instances whose box meets its patch (4
// ballots a chunk), classifies its pixels and composites them without a
// branch per pixel. The tile-wide exit vote ends each chunk. No tensor
// cores, TMA or double buffering.
//
// K1-span runs the span options as the cluster program of composite.cuh
// (run_cluster_program), as K2-span and K4 do: one CTA per tile, a program
// of `tpp` consecutive tiles as clusters of CTAs. A program's instances are
// one contiguous run of the sorted array, so when the run's chunks fit a
// window of span_cap chunks the window is staged once, spread over the
// cluster's shared memory (5,632 bytes a chunk, ceil(span_cap / c) chunks a
// CTA), and each CTA copies the chunks its tile walks from their owners
// through distributed shared memory; a program that does not fit stages
// chunk by chunk from rows16, as K1 does. Its tile's walk is K1's
// (composite_tile_patched), the same float operations in the same order,
// so its values are K1's bit for bit; only where a chunk's rows come from
// differs.

#include "composite.cuh"

namespace {

using composite::kChunk;
using composite::kRows;
using composite::kThreads;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                 const float* __restrict__ rows16, float* __restrict__ out,
                 int tw, int width, int height, int64_t b_pad, float bg0,
                 float bg1, float bg2) {
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  composite::composite_tile_patched<PPT, false>(
      blockIdx.x, starts, counts, nullptr, rows16, out, nullptr, tw, width,
      height, b_pad, bg0, bg1, bg2, sh, boxes);
}

// K1-span: K1's walk of this CTA's tile, from the cluster's window when its
// program fits (composite.cuh::run_cluster_program).
template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_span_kernel(const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ rows16, float* __restrict__ out,
                      int tw, int width, int height, int64_t b_pad, float bg0,
                      float bg1, float bg2, int tpp, int span_cap) {
  extern __shared__ __align__(128) float window[];
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  __shared__ uint64_t bar;
  composite::run_cluster_program(
      starts, counts, rows16, b_pad, tpp, span_cap, window, &bar,
      [&](int tile, auto stage) {
        composite::composite_tile_patched<PPT, false>(
            tile, starts, counts, nullptr, rows16, out, nullptr, tw, width,
            height, b_pad, bg0, bg1, bg2, sh, boxes, stage);
      });
}

}  // namespace

// Launches K1 on `stream`. Pointers are device pointers to contiguous
// starts/counts i32 [n_tiles], rows16 f32 [16, b_pad] and out f32
// [n_tiles, 8, tile_size^2]; the frame is width x height pixels on tiles of
// tw per row (the last row and column of tiles may be partial: the walk is
// clipped to the frame). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported tile_size).
extern "C" int tiled_fwd_launch(const void* starts, const void* counts,
                                const void* rows16, void* out, int n_tiles,
                                int tw, int width, int height, int64_t b_pad,
                                int tile_size, float bg0, float bg1, float bg2,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const float* rows = static_cast<const float*>(rows16);
  float* o = static_cast<float*>(out);
  if (tile_size == 32) {
    tiled_fwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(st, ct, rows, o, tw, width,
                                                     height, b_pad, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_fwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(st, ct, rows, o, tw, width,
                                                     height, b_pad, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1 that one SM holds at once at `tile_size`, as the runtime's
// occupancy calculator counts them from the kernel's registers and shared
// memory; -1 for an unsupported tile_size or a runtime error.
extern "C" int tiled_fwd_blocks_per_sm(int tile_size) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (tile_size == 32)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tiled_fwd_kernel<4>,
                                                        kThreads, 0);
  else if (tile_size == 16)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tiled_fwd_kernel<1>,
                                                        kThreads, 0);
  return err == cudaSuccess ? n : -1;
}

// Launches K1-span on `stream`: as tiled_fwd_launch, with n_tiles CTAs in
// clusters of composite::span_cluster_size(tpp) and a window of span_cap
// chunks spread over each cluster (1 <= span_cap <= b_pad / 128, tpp
// dividing n_tiles, rows16 16 B aligned; a CTA's share of the window and
// its static shared memory must fit a block's). Returns the CUDA error of
// the attribute call or of the cluster launch (cudaErrorInvalidValue for
// arguments it cannot take).
extern "C" int tiled_fwd_span_launch(const void* starts, const void* counts,
                                     const void* rows16, void* out, int n_tiles,
                                     int tw, int width, int height, int64_t b_pad,
                                     int tile_size, float bg0, float bg1,
                                     float bg2, int tpp, int span_cap,
                                     void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap) ||
      !composite::bulk_rows_ok(rows16, b_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const float* rows = static_cast<const float*>(rows16);
  float* o = static_cast<float*>(out);
  if (tile_size == 32)
    return composite::launch_span_cluster(tiled_fwd_span_kernel<4>, n_tiles, tpp,
                                          span_cap, s, st, ct, rows, o, tw, width,
                                          height, b_pad, bg0, bg1, bg2);
  if (tile_size == 16)
    return composite::launch_span_cluster(tiled_fwd_span_kernel<1>, n_tiles, tpp,
                                          span_cap, s, st, ct, rows, o, tw, width,
                                          height, b_pad, bg0, bg1, bg2);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The occupancy of K1-span launched on n_tiles tiles of `tile_size` with
// (tpp, span_cap): out[0] blocks an SM, out[1] clusters resident on the card
// at once, out[2] the cluster size, out[3] the kernel's static shared
// memory. Returns the CUDA error (cudaErrorInvalidValue for an unsupported
// tile_size).
extern "C" int tiled_fwd_span_occupancy(int tile_size, int n_tiles, int tpp,
                                        int span_cap, int* out) {
  if (tile_size == 32)
    return composite::span_cluster_occupancy(tiled_fwd_span_kernel<4>, n_tiles,
                                             tpp, span_cap, out);
  if (tile_size == 16)
    return composite::span_cluster_occupancy(tiled_fwd_span_kernel<1>, n_tiles,
                                             tpp, span_cap, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
