// Shared by the tile kernels K1 and K1-span (tiled_fwd.cu), K2, K2-span, K3
// and K4 (tiled_train.cu): the per-pair classification, the front-to-back
// tile walk and the span window of a multi-tile program.
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

// The forward walk of one tile (one 256-thread block, PPT pixels per
// thread; tile_size^2 == PPT * 256): for every pixel
//   w = alpha T;  T *= 1 - alpha;  sum w * (r, g, b, depth, 1)
// over the tile's live instances in order, stopping after the first chunk
// at which max over the tile's pixels of T is <= 1e-4 (a tile-wide vote).
// Writes out [n_tiles, 8, p]: r, g, b + bg (1 - sum w), depth, alpha =
// sum w, then three zero rows.
//
// Where a chunk's rows come from is the only difference between the
// kernels' default and span forms: with kSpan false each chunk is staged in
// `sh` (load_chunk) before it is walked; with kSpan true the chunk kt + ci
// is read at slot kt + ci - k0c of `span`, which the block staged once.
//
// kRecord (K2) also stores every pixel's T at the start of each chunk it
// walks to tb[(offset + ci) * p + pixel], and zeros for the tile's chunks
// after the exit, so "never started" reads as "max boundary is 0".
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

// Says at compile time which walk a tile of a program takes.
template <bool kSpan>
struct SpanTag {
  static constexpr bool value = kSpan;
};

// One program of a span kernel (K1-span, K2-span, K4): `tpp` consecutive
// tiles per block. When the tiles' chunks fit the window, the block stages
// them once in `span` (dynamic shared memory, span_cap chunks) and calls
// tile_fn(tile, SpanTag<true>, nullptr, span, k0c) for each tile; otherwise
// every tile takes the per-chunk walk, tile_fn(tile, SpanTag<false>, sh,
// nullptr, 0), staging each chunk in the window's first slot `sh`. `fits` is
// uniform over the block, so the barriers inside the walks are too.
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

// One program of the span forms K1-span (kRecord false) and K2-span.
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

// Launches a span kernel on `stream`: n_tiles / tpp blocks with a window of
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

}  // namespace composite
