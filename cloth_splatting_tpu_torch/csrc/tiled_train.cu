// K2 and K3: the training rasterizer's forward and backward tile kernels.
//
// K2 replaces the TPU kernel cloth_splatting_tpu/ops/rasterize/
// pallas_train.py::_fwd_train_kernel; K3 replaces pallas_train.py::
// _bwd_kernel_fwd_order with chunk_grads (the span_cap=0 backward). Python
// wrappers and plain PyTorch versions: ops/rasterize/tiled_train.py
// (raster_forward_train / raster_forward_train_plain, run_backward /
// run_backward_plain).
//
// K2 is K1's walk (composite.cuh::composite_tile) that also stores every
// pixel's transmittance T at the start of each chunk it walks, in a flat
// tb [n_flat_chunks, p] buffer (tile t's chunk ci at row offsets[t] + ci;
// the TPU kernel's [group, p, 128] packing was a DMA alignment device), and
// zeros for the chunks after its exit.
//
// K3 walks, per tile, the chunks K2 started, in forward order. With
// g = (g_r, g_g, g_b, g_dep) the cotangent of (r, g, b, depth) at a pixel,
// c_i = (r, g, b, depth) of instance i, w_i = alpha_i T_i, and the closed
// forms U_tot = sum_i (g . c_i) w_i and K = (g_acc - g_rgb . bg) (1 - acc)
// that the wrapper puts into gimg [n_tiles, p, 8] (g_r g_g g_b g_dep g_acc
// acc U_tot 0):
//   T_i    = T at the chunk's boundary times prod_{j<i in chunk} (1 - alpha_j)
//   u_i    = g . c_i,   S_i = U_tot - sum_{j<=i} u_j w_j
//   dL/dalpha_i = u_i T_i + (K - S_i) / max(1 - alpha_i, 1e-3)
//   dpow_i = dL/dalpha_i * opacity e^power   (0 where the pair is clamped)
// and, summed over the tile's pixels, per instance:
//   d(x, y)   = (a sum dpow dx + b sum dpow dy, c sum dpow dy + b sum dpow dx)
//   d(a,b,c)  = (-sum dpow dx^2 / 2, -sum dpow dx dy, -sum dpow dy^2 / 2)
//   d(r,g,b)  = sum g_rgb w,  d depth = sum g_dep w,  d opacity = sum dpow / op
// into grads [16, b_pad] (rows as rows16; rows 10..15 stay zero).
//
// What bounds them on the H100: fp32 arithmetic, as K1 (~14 operations per
// walked pair; ~42 more per contributing pair in K3), against tens of MB of
// traffic. K3 also reduces ten sums per instance over the tile's pixels.
//
// What the design does about it: K2 is K1 plus one coalesced store of p
// floats per chunk. K3 keeps K1's layout (256-thread block per tile, PPT
// pixels per thread, the chunk's rows in shared memory) and carries each
// pixel's T, prefix and cotangents in registers. Each instance's ten sums
// are reduced per warp with shuffles (skipped when no pixel of the warp
// sees the instance), parked in shared memory [10][8 warps][128], and
// summed over the warps after the chunk by one thread per instance. The
// pack is tile-grouped and only live lanes [start, start + count) are
// written, so every slot belongs to exactly one tile: plain stores, no
// atomics, and the result does not depend on block order. The TPU kernel's
// rolling accumulator and read-modify-write (pallas_train.py:401-449), and
// its tile-local moments (an MXU device), have no counterpart here.

#include "composite.cuh"

namespace {

using composite::kChunk;
using composite::kRows;
using composite::kThreads;

constexpr int kWarps = kThreads / 32;
// per-instance pixel sums: dpow, dpow dx, dpow dy, dpow dx^2, dpow dy^2,
// dpow dx dy, w g_r, w g_g, w g_b, w g_dep
constexpr int kSums = 10;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_train_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const int* __restrict__ offsets,
                       const float* __restrict__ rows16, float* __restrict__ out,
                       float* __restrict__ tb, int tw, int64_t b_pad,
                       int tile_size, float bg0, float bg1, float bg2) {
  composite::composite_tile<PPT, true>(starts, counts, offsets, rows16, out, tb,
                                       tw, b_pad, tile_size, bg0, bg1, bg2);
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_bwd_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                 const int* __restrict__ offsets,
                 const float* __restrict__ rows16,
                 const float* __restrict__ gimg, const float* __restrict__ tb,
                 float* __restrict__ grads, int tw, int64_t b_pad,
                 int tile_size, float bg0, float bg1, float bg2) {
  using namespace composite;
  __shared__ float sh[kRows][kChunk];
  __shared__ float red[kSums][kWarps][kChunk];

  const int tile = blockIdx.x;
  const int p = tile_size * tile_size;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const float* tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;
  const int ox = (tile % tw) * tile_size;
  const int oy = (tile / tw) * tile_size;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], gd[PPT], kk[PPT];
  float u_tot[PPT], carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    px[i] = static_cast<float>(ox + pix % tile_size);
    py[i] = static_cast<float>(oy + pix / tile_size);
    const float* g = gimg + (static_cast<int64_t>(tile) * p + pix) * 8;
    gr[i] = g[0];
    gg[i] = g[1];
    gb[i] = g[2];
    gd[i] = g[3];
    kk[i] = (g[4] - (gr[i] * bg0 + gg[i] * bg1 + gb[i] * bg2)) * (1.0f - g[5]);
    u_tot[i] = g[6];
    carry[i] = 0.0f;
  }

  for (int ci = 0; ci < n_chunks; ++ci) {
    float T[PPT];
    bool started = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = tb_tile[static_cast<int64_t>(ci) * p + threadIdx.x + i * kThreads];
      started |= T[i] > 0.0f;
    }
    // barrier (the previous chunk's reduction has read sh and red) and the
    // vote: a chunk K2 never started has an all-zero boundary, and so has
    // every later chunk of the tile; their slots keep the wrapper's zeros
    if (!__syncthreads_or(started)) break;
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    load_chunk(sh, rows16, b_pad, base);
    __syncthreads();

    float rem[PPT], cum[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      rem[i] = u_tot[i] - carry[i];
      cum[i] = 0.0f;
    }
    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    for (int j = lo; j < hi; ++j) {
      const float gx = sh[kX][j], gy = sh[kY][j];
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
      const float op = sh[kOp][j], dep = sh[kDepth][j], cut = sh[kCut][j];
      float s[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
      bool seen = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = px[i] - gx;
        const float dy = py[i] - gy;
        float a_raw, alpha;
        if (!splat_alpha(dx, dy, ca, cb, cc, op, cut, &a_raw, &alpha)) continue;
        seen = true;
        const float w = alpha * T[i];
        const float u = gr[i] * cr + gg[i] * cg + gb[i] * cbl + gd[i] * dep;
        cum[i] += u * w;
        s[6] += gr[i] * w;
        s[7] += gg[i] * w;
        s[8] += gb[i] * w;
        s[9] += gd[i] * w;
        if (a_raw <= kAlphaMax) {
          const float dl_da =
              u * T[i] + (kk[i] - (rem[i] - cum[i])) / fmaxf(1.0f - alpha, 1e-3f);
          const float dpow = dl_da * a_raw;
          s[0] += dpow;
          s[1] += dpow * dx;
          s[2] += dpow * dy;
          s[3] += dpow * dx * dx;
          s[4] += dpow * dy * dy;
          s[5] += dpow * dx * dy;
        }
        T[i] *= 1.0f - alpha;
      }
      if (__any_sync(0xffffffffu, seen)) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
          float v = s[k];
#pragma unroll
          for (int sh_off = 16; sh_off > 0; sh_off /= 2)
            v += __shfl_xor_sync(0xffffffffu, v, sh_off);
          if (lane == 0) red[k][warp][j] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) red[k][warp][j] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) carry[i] += cum[i];
    __syncthreads();

    // one thread per live instance of the chunk: sum over the warps, form
    // the parameter gradients and store them (coalesced along the chunk)
    for (int j = threadIdx.x; j < kChunk; j += kThreads) {
      if (j < lo || j >= hi) continue;
      float t[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[k][w][j];
        t[k] = v;
      }
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      float* g = grads + base + j;
      g[0 * b_pad] = ca * t[1] + cb * t[2];
      g[1 * b_pad] = cc * t[2] + cb * t[1];
      g[2 * b_pad] = -0.5f * t[3];
      g[3 * b_pad] = -t[5];
      g[4 * b_pad] = -0.5f * t[4];
      g[5 * b_pad] = t[6];
      g[6 * b_pad] = t[7];
      g[7 * b_pad] = t[8];
      g[8 * b_pad] = t[0] / fmaxf(sh[kOp][j], 1e-30f);
      g[9 * b_pad] = t[9];
    }
  }
}

}  // namespace

// Launches K2 on `stream`. Device pointers to contiguous starts/counts/
// offsets i32 [n_tiles], rows16 f32 [16, b_pad], out f32 [n_tiles, 8, p] and
// tb f32 [>= sum of the tiles' chunk counts, p]. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported tile_size).
extern "C" int tiled_fwd_train_launch(const void* starts, const void* counts,
                                      const void* offsets, const void* rows16,
                                      void* out, void* tb, int n_tiles, int tw,
                                      int64_t b_pad, int tile_size, float bg0,
                                      float bg1, float bg2, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* of = static_cast<const int*>(offsets);
  const float* rows = static_cast<const float*>(rows16);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(tb);
  if (tile_size == 32) {
    tiled_fwd_train_kernel<4><<<n_tiles, kThreads, 0, s>>>(
        st, ct, of, rows, o, t, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_fwd_train_kernel<1><<<n_tiles, kThreads, 0, s>>>(
        st, ct, of, rows, o, t, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on `stream`. As K2, plus gimg f32 [n_tiles, p, 8], tb as K2
// wrote it, and grads f32 [16, b_pad], which the caller zeroes: K3 writes
// only the live slots of chunks K2 started.
extern "C" int tiled_bwd_launch(const void* starts, const void* counts,
                                const void* offsets, const void* rows16,
                                const void* gimg, const void* tb, void* grads,
                                int n_tiles, int tw, int64_t b_pad,
                                int tile_size, float bg0, float bg1, float bg2,
                                void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* st = static_cast<const int*>(starts);
  const int* ct = static_cast<const int*>(counts);
  const int* of = static_cast<const int*>(offsets);
  const float* rows = static_cast<const float*>(rows16);
  const float* gi = static_cast<const float*>(gimg);
  const float* t = static_cast<const float*>(tb);
  float* g = static_cast<float*>(grads);
  if (tile_size == 32) {
    tiled_bwd_kernel<4><<<n_tiles, kThreads, 0, s>>>(
        st, ct, of, rows, gi, t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_bwd_kernel<1><<<n_tiles, kThreads, 0, s>>>(
        st, ct, of, rows, gi, t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
