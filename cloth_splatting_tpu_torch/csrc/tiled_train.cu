// K2, K2-span, K3 and K4: the training rasterizer's forward and backward
// tile kernels.
//
// K2 replaces the TPU kernel cloth_splatting_tpu/ops/rasterize/
// pallas_train.py::_fwd_train_kernel and K2-span its span branch
// (one_tile_vmem); K3 replaces pallas_train.py::_bwd_kernel_fwd_order with
// chunk_grads (the span_cap=0 backward) and K4 pallas_train.py::_bwd_kernel,
// the reverse sweep that runs when span_cap > 0. Python wrappers and plain
// PyTorch versions: ops/rasterize/tiled_train.py (raster_forward_train /
// raster_forward_train_plain, run_backward / run_backward_plain).
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
//
// K2-span is K2 for a block of tpp consecutive tiles that stages their
// chunks once when they fit a window of span_cap chunks (composite.cuh::
// composite_program); it writes the boundaries exactly as K2.
//
// K4 owns tpp tiles per block as K2-span does and sweeps each tile's chunks
// last to first, carrying per pixel s_carry = sum of u w over the LATER
// chunks. Inside a chunk S_i = (chunk_total - sum_{j<=i} u_j w_j) + s_carry,
// and chunk_total is needed before the first instance's S_i, so a thread
// makes two passes over the chunk's lanes: the first runs the T chain and
// sums u w, the second recomputes each pair (same splat_alpha, so the same
// pairs) and forms the gradients through the function K3 uses. A chunk
// whose saved boundary is all zero was never started by the forward: it is
// skipped and the carry stays. K4 does not read U_tot. Every slot belongs
// to one tile, so K4 stores as K3 does; the TPU kernel's gradient window
// read-back and its shared-chunk read-modify-write have no counterpart.
// Twice K3's expf per pair and fewer blocks: expected slower than K3.

#include "composite.cuh"

namespace {

using composite::kChunk;
using composite::kRows;
using composite::kThreads;

constexpr int kWarps = kThreads / 32;
// per-instance pixel sums: dpow, dpow dx, dpow dy, dpow dx^2, dpow dy^2,
// dpow dx dy, w g_r, w g_g, w g_b, w g_dep
constexpr int kSums = 10;

// What a backward thread keeps per pixel of its tile.
template <int PPT>
struct PixelFields {
  float px[PPT], py[PPT], gr[PPT], gg[PPT], gb[PPT], gd[PPT], kk[PPT];
  float u_tot[PPT];
};

template <int PPT>
__device__ __forceinline__ void load_pixel_fields(
    PixelFields<PPT>& f, const float* __restrict__ gimg, int tile, int tw,
    int tile_size, float bg0, float bg1, float bg2) {
  const int p = tile_size * tile_size;
  const int ox = (tile % tw) * tile_size;
  const int oy = (tile / tw) * tile_size;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int pix = threadIdx.x + i * kThreads;
    f.px[i] = static_cast<float>(ox + pix % tile_size);
    f.py[i] = static_cast<float>(oy + pix / tile_size);
    const float* g = gimg + (static_cast<int64_t>(tile) * p + pix) * 8;
    f.gr[i] = g[0];
    f.gg[i] = g[1];
    f.gb[i] = g[2];
    f.gd[i] = g[3];
    f.kk[i] = (g[4] - (f.gr[i] * bg0 + f.gg[i] * bg1 + f.gb[i] * bg2)) *
              (1.0f - g[5]);
    f.u_tot[i] = g[6];
  }
}

// One contributing pair's terms of its instance's ten sums; K3 and K4
// differ only in where the occlusion suffix s_i comes from.
__device__ __forceinline__ void pair_grad(float* s, float dx, float dy,
                                          float a_raw, float alpha, float T,
                                          float w, float u, float kk, float s_i,
                                          float gr, float gg, float gb,
                                          float gd) {
  s[6] += gr * w;
  s[7] += gg * w;
  s[8] += gb * w;
  s[9] += gd * w;
  if (a_raw <= composite::kAlphaMax) {
    const float dl_da = u * T + (kk - s_i) / fmaxf(1.0f - alpha, 1e-3f);
    const float dpow = dl_da * a_raw;
    s[0] += dpow;
    s[1] += dpow * dx;
    s[2] += dpow * dy;
    s[3] += dpow * dx * dx;
    s[4] += dpow * dy * dy;
    s[5] += dpow * dx * dy;
  }
}

// Sums instance j's ten sums over the warp and parks them in red; a warp
// none of whose pixels saw the instance parks zeros.
__device__ __forceinline__ void park_warp_sums(
    float (*red)[kWarps][kChunk], const float* s, bool seen, int warp,
    int lane, int j) {
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

// One thread per live instance of the chunk: sum over the warps, form the
// parameter gradients and store them (coalesced along the chunk).
__device__ __forceinline__ void store_chunk_grads(
    float (*red)[kWarps][kChunk], composite::ChunkRows rows,
    float* __restrict__ grads, int64_t b_pad, int64_t base, int lo, int hi) {
  using namespace composite;
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
    const float ca = rows[kA][j], cb = rows[kB][j], cc = rows[kC][j];
    float* g = grads + base + j;
    g[0 * b_pad] = ca * t[1] + cb * t[2];
    g[1 * b_pad] = cc * t[2] + cb * t[1];
    g[2 * b_pad] = -0.5f * t[3];
    g[3 * b_pad] = -t[5];
    g[4 * b_pad] = -0.5f * t[4];
    g[5 * b_pad] = t[6];
    g[6 * b_pad] = t[7];
    g[7 * b_pad] = t[8];
    g[8 * b_pad] = t[0] / fmaxf(rows[kOp][j], 1e-30f);
    g[9 * b_pad] = t[9];
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_train_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const int* __restrict__ offsets,
                       const float* __restrict__ rows16, float* __restrict__ out,
                       float* __restrict__ tb, int tw, int64_t b_pad,
                       int tile_size, float bg0, float bg1, float bg2) {
  __shared__ float sh[kRows][kChunk];
  composite::composite_tile<PPT, true, false>(
      blockIdx.x, starts, counts, offsets, rows16, out, tb, tw, b_pad,
      tile_size, bg0, bg1, bg2, sh, nullptr, 0);
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_train_span_kernel(const int* __restrict__ starts,
                            const int* __restrict__ counts,
                            const int* __restrict__ offsets,
                            const float* __restrict__ rows16,
                            float* __restrict__ out, float* __restrict__ tb,
                            int tw, int64_t b_pad, int tile_size, float bg0,
                            float bg1, float bg2, int tpp, int span_cap) {
  extern __shared__ float span[];
  composite::composite_program<PPT, true>(starts, counts, offsets, rows16, out,
                                          tb, tw, b_pad, tile_size, bg0, bg1,
                                          bg2, tpp, span_cap, span);
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
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  PixelFields<PPT> f;
  load_pixel_fields(f, gimg, tile, tw, tile_size, bg0, bg1, bg2);
  float carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) carry[i] = 0.0f;

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
      rem[i] = f.u_tot[i] - carry[i];
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
        const float dx = f.px[i] - gx;
        const float dy = f.py[i] - gy;
        float a_raw, alpha;
        if (!splat_alpha(dx, dy, ca, cb, cc, op, cut, &a_raw, &alpha)) continue;
        seen = true;
        const float w = alpha * T[i];
        const float u =
            f.gr[i] * cr + f.gg[i] * cg + f.gb[i] * cbl + f.gd[i] * dep;
        cum[i] += u * w;
        pair_grad(s, dx, dy, a_raw, alpha, T[i], w, u, f.kk[i],
                  rem[i] - cum[i], f.gr[i], f.gg[i], f.gb[i], f.gd[i]);
        T[i] *= 1.0f - alpha;
      }
      park_warp_sums(red, s, seen, warp, lane, j);
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) carry[i] += cum[i];
    __syncthreads();
    store_chunk_grads(red, const_cast<ChunkRows>(sh), grads, b_pad, base, lo,
                      hi);
  }
}

// K4: the reverse sweep of one tile, from the window the block staged
// (kSpan) or staging each chunk in `sh`. A block sweeps several tiles one
// after another: every write to red or sh follows a chunk's vote, which is a
// barrier, so the previous tile's last reduction has been read by then.
template <int PPT, bool kSpan>
__device__ __forceinline__ void reverse_tile(
    int tile, const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    const float* __restrict__ gimg, const float* __restrict__ tb,
    float* __restrict__ grads, int tw, int64_t b_pad, int tile_size, float bg0,
    float bg1, float bg2, float (*red)[kWarps][kChunk], float (*sh)[kChunk],
    const float* span, int k0c) {
  using namespace composite;
  const int p = tile_size * tile_size;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const float* tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  PixelFields<PPT> f;
  load_pixel_fields(f, gimg, tile, tw, tile_size, bg0, bg1, bg2);
  float s_carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) s_carry[i] = 0.0f;

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    float t_start[PPT];
    bool started = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      t_start[i] =
          tb_tile[static_cast<int64_t>(ci) * p + threadIdx.x + i * kThreads];
      started |= t_start[i] > 0.0f;
    }
    // barrier (the previous chunk's reduction has read sh and red) and the
    // vote: an all-zero boundary marks a chunk the forward never started;
    // its slots keep the wrapper's zeros and the carry stays
    if (!__syncthreads_or(started)) continue;
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

    // pass 1: the chunk's total of u w per pixel
    float T[PPT], total[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = t_start[i];
      total[i] = 0.0f;
    }
    for (int j = lo; j < hi; ++j) {
      const float gx = rows[kX][j], gy = rows[kY][j];
      const float ca = rows[kA][j], cb = rows[kB][j], cc = rows[kC][j];
      const float cr = rows[kR][j], cg = rows[kG][j], cbl = rows[kBl][j];
      const float op = rows[kOp][j], dep = rows[kDepth][j], cut = rows[kCut][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float a_raw, alpha;
        if (!splat_alpha(f.px[i] - gx, f.py[i] - gy, ca, cb, cc, op, cut,
                         &a_raw, &alpha))
          continue;
        const float u =
            f.gr[i] * cr + f.gg[i] * cg + f.gb[i] * cbl + f.gd[i] * dep;
        total[i] += u * (alpha * T[i]);
        T[i] *= 1.0f - alpha;
      }
    }

    // pass 2: the same pairs again, now with S_i known
    float cum[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = t_start[i];
      cum[i] = 0.0f;
    }
    for (int j = lo; j < hi; ++j) {
      const float gx = rows[kX][j], gy = rows[kY][j];
      const float ca = rows[kA][j], cb = rows[kB][j], cc = rows[kC][j];
      const float cr = rows[kR][j], cg = rows[kG][j], cbl = rows[kBl][j];
      const float op = rows[kOp][j], dep = rows[kDepth][j], cut = rows[kCut][j];
      float s[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
      bool seen = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = f.px[i] - gx;
        const float dy = f.py[i] - gy;
        float a_raw, alpha;
        if (!splat_alpha(dx, dy, ca, cb, cc, op, cut, &a_raw, &alpha)) continue;
        seen = true;
        const float w = alpha * T[i];
        const float u =
            f.gr[i] * cr + f.gg[i] * cg + f.gb[i] * cbl + f.gd[i] * dep;
        cum[i] += u * w;
        pair_grad(s, dx, dy, a_raw, alpha, T[i], w, u, f.kk[i],
                  (total[i] - cum[i]) + s_carry[i], f.gr[i], f.gg[i], f.gb[i],
                  f.gd[i]);
        T[i] *= 1.0f - alpha;
      }
      park_warp_sums(red, s, seen, warp, lane, j);
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) s_carry[i] += total[i];
    __syncthreads();
    store_chunk_grads(red, rows, grads, b_pad, base, lo, hi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_bwd_reverse_kernel(const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         const int* __restrict__ offsets,
                         const float* __restrict__ rows16,
                         const float* __restrict__ gimg,
                         const float* __restrict__ tb, float* __restrict__ grads,
                         int tw, int64_t b_pad, int tile_size, float bg0,
                         float bg1, float bg2, int tpp, int span_cap) {
  using namespace composite;
  extern __shared__ float span[];
  __shared__ float red[kSums][kWarps][kChunk];

  for_each_tile_of_program(
      starts, counts, rows16, b_pad, tpp, span_cap, span,
      [&](int tile, auto in_span, float (*sh)[kChunk], const float* window,
          int k0c) {
        reverse_tile<PPT, decltype(in_span)::value>(
            tile, starts, counts, offsets, rows16, gimg, tb, grads, tw, b_pad,
            tile_size, bg0, bg1, bg2, red, sh, window, k0c);
      });
}

struct Args {
  const int *st, *ct, *of;
  const float* rows;
  cudaStream_t s;
};

Args unpack(const void* starts, const void* counts, const void* offsets,
            const void* rows16, void* stream) {
  return {static_cast<const int*>(starts), static_cast<const int*>(counts),
          static_cast<const int*>(offsets), static_cast<const float*>(rows16),
          static_cast<cudaStream_t>(stream)};
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
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(tb);
  if (tile_size == 32) {
    tiled_fwd_train_kernel<4><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, o, t, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_fwd_train_kernel<1><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, o, t, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K2-span on `stream`: as tiled_fwd_train_launch, with n_tiles / tpp
// blocks of tpp tiles and a window of span_cap chunks (1 <= span_cap <=
// b_pad / 128, tpp dividing n_tiles; the window must fit a block's shared
// memory). Returns the CUDA error of the attribute call or of the launch.
extern "C" int tiled_fwd_train_span_launch(
    const void* starts, const void* counts, const void* offsets,
    const void* rows16, void* out, void* tb, int n_tiles, int tw, int64_t b_pad,
    int tile_size, float bg0, float bg1, float bg2, int tpp, int span_cap,
    void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(tb);
  if (tile_size == 32)
    return composite::launch_span(tiled_fwd_train_span_kernel<4>, n_tiles, tpp,
                                  span_cap, a.s, a.st, a.ct, a.of, a.rows, o, t,
                                  tw, b_pad, tile_size, bg0, bg1, bg2);
  if (tile_size == 16)
    return composite::launch_span(tiled_fwd_train_span_kernel<1>, n_tiles, tpp,
                                  span_cap, a.s, a.st, a.ct, a.of, a.rows, o, t,
                                  tw, b_pad, tile_size, bg0, bg1, bg2);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  const float* gi = static_cast<const float*>(gimg);
  const float* t = static_cast<const float*>(tb);
  float* g = static_cast<float*>(grads);
  if (tile_size == 32) {
    tiled_bwd_kernel<4><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, gi, t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_bwd_kernel<1><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, gi, t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K4 on `stream`: K3's arguments (gimg's U_tot column is not
// read), with n_tiles / tpp blocks of tpp tiles and a window of span_cap
// chunks beside the 40 KB of reduction scratch. The caller zeroes grads.
extern "C" int tiled_bwd_reverse_launch(
    const void* starts, const void* counts, const void* offsets,
    const void* rows16, const void* gimg, const void* tb, void* grads,
    int n_tiles, int tw, int64_t b_pad, int tile_size, float bg0, float bg1,
    float bg2, int tpp, int span_cap, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  const float* gi = static_cast<const float*>(gimg);
  const float* t = static_cast<const float*>(tb);
  float* g = static_cast<float*>(grads);
  if (tile_size == 32)
    return composite::launch_span(tiled_bwd_reverse_kernel<4>, n_tiles, tpp,
                                  span_cap, a.s, a.st, a.ct, a.of, a.rows, gi,
                                  t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  if (tile_size == 16)
    return composite::launch_span(tiled_bwd_reverse_kernel<1>, n_tiles, tpp,
                                  span_cap, a.s, a.st, a.ct, a.of, a.rows, gi,
                                  t, g, tw, b_pad, tile_size, bg0, bg1, bg2);
  return static_cast<int>(cudaErrorInvalidValue);
}
