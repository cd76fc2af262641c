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
// K2 is K1's walk (composite.cuh::composite_tile_patched) that also stores
// every pixel's transmittance T at the start of each chunk it walks, in a
// flat tb [n_flat_chunks, p] buffer (tile t's chunk ci at row offsets[t] +
// ci; the TPU kernel's [group, p, 128] packing was a DMA alignment device),
// and zeros for the chunks after its exit.
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
// classified pair; ~42 more per contributing pair in K3), against tens of
// MB of traffic. K3 also reduces ten sums per instance over the tile's
// pixels.
//
// K2 is K1 plus one store of p floats per chunk: the patched walk (warp
// patches, the footprint cull, no branch per pixel) that K1's notes in
// tiled_fwd.cu describe.
//
// K3 (one 256-thread block per tile, the chunk's rows in shared memory,
// each pixel's T, prefix and cotangents in registers). What bounds it on
// the H100 is the walk: per chunk, each warp steps through the instances it
// walks one after another (classify its pixels, their terms, the warp's
// reduction), and the chunk's barrier waits for the slowest warp. Its first
// form made that walk long: threads owned pixels t + i*256, so a warp held
// four rows spread over the whole tile and saw nearly every instance of it;
// all 8 warps classified every instance on all their pixels and reduced
// its ten sums with 50 shuffles. What the design does about it:
//   - compact warp patches: warp w owns a 16x8 rectangle of a 32 px tile
//     (8x4 of a 16 px tile) and each lane a 2x2 quad of it (a single pixel
//     at 16 px); patch_pixel is the one map from (warp, lane, i) to the
//     pixel;
//   - exact footprint culling: when a chunk is staged, each instance also
//     gets a conservative box (footprint_box) that holds every pixel where
//     splat_alpha can find the pair alive; a warp tests its patch against
//     the 128 boxes with 4 ballots and walks only the instances that hit
//     it, in lane order. A skipped instance is dead at every pixel of the
//     warp, where the full walk changes no T, prefix or sum, so each
//     pixel's values are the same float operations as without the cull;
//   - no branch per pixel: a lane classifies its pixels first and then runs
//     their terms with a dead pixel's alpha and offsets at 0, which changes
//     its T, prefix and sums by exact zeros, so the pixels' chains interleave
//     (a branch per pixel ran each pixel's terms in turn for the whole warp
//     whenever one lane's pixel was alive);
//   - a cheaper reduction: a warp reduces only the instances it walked and
//     some pixel of it saw, with a reduce-scatter butterfly (12 shuffles
//     for ten sums, each sum ending at one lane), records which in a
//     per-warp mask, and after the chunk all 256 threads (two an instance,
//     five sums each) add the warps that reduced it in warp order;
//   - registers capped for kBwdBlocksPerSm blocks an SM (3 blocks spilled
//     and ran slower).
// The pack is tile-grouped and only live lanes [start, start + count) are
// written, so every slot belongs to exactly one tile: plain stores, no
// atomics, and the sums go in a fixed order, so the result is the same bits
// from run to run and does not depend on block order. The TPU kernel's
// rolling accumulator and read-modify-write (pallas_train.py:401-449), and
// its tile-local moments (an MXU device), have no counterpart here.
//
// K2-span and K4 run the span options as the cluster program of
// composite.cuh (run_cluster_program): one CTA per tile, a program of tpp
// tiles as clusters of CTAs, the window that a fitting program stages once
// spread over the cluster's shared memory and read through distributed
// shared memory, so that a CTA's shared memory does not hold a whole window
// (41 chunks are 231 KB: one 8-warp block an SM) and every tile of a program
// is in flight at once.
//
// K2-span runs K2's walk (composite_tile_patched) on its tile, the chunk's
// rows copied from the window when the program fits: every pixel goes
// through the same float operations as in K2, so it gives K2's bits, its
// boundaries included (chip_smoke holds it to that).
//
// K4 sweeps its tile's chunks last to first, carrying per pixel s_carry =
// sum of u w over the LATER chunks. Inside a chunk S_i = (chunk_total -
// sum_{j<=i} u_j w_j) + s_carry, and chunk_total is needed before the first
// instance's S_i, so it walks each chunk twice: pass 1 runs the T chain and
// sums u w, pass 2 recomputes each pair (the same splat_alpha, so the same
// pairs) and forms the gradients through the function K3 uses. It walks as
// K3 does: the warp patches, the footprint cull (both passes walk only the
// warp's hit instances, the same ones), a lane's pixels classified first
// with a dead pixel's alpha and offsets at 0, and the reduce-scatter,
// per-warp mask and fixed-order cross-warp pass, so that both passes cost
// what the cull leaves of the pairs. A chunk whose saved boundary is all
// zero was never started by the forward: it is skipped and the carry
// stays. K4 does not read U_tot. Every slot belongs to one tile,
// so K4 stores as K3 does; the TPU kernel's gradient window read-back and
// its shared-chunk read-modify-write have no counterpart.

#include "composite.cuh"

namespace {

using composite::kChunk;
using composite::kRows;
using composite::kThreads;

constexpr int kWarps = kThreads / 32;
// per-instance pixel sums: dpow, dpow dx, dpow dy, dpow dx^2, dpow dy^2,
// dpow dx dy, w g_r, w g_g, w g_b, w g_dep
constexpr int kSums = 10;

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

template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_train_kernel(const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const int* __restrict__ offsets,
                       const float* __restrict__ rows16, float* __restrict__ out,
                       float* __restrict__ tb, int tw, int64_t b_pad,
                       float bg0, float bg1, float bg2) {
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  composite::composite_tile_patched<PPT, true>(
      blockIdx.x, starts, counts, offsets, rows16, out, tb, tw, b_pad, bg0,
      bg1, bg2, sh, boxes);
}

// K2-span: K2's walk of this CTA's tile, from the cluster's window when its
// program fits (composite.cuh::run_cluster_program).
template <int PPT>
__global__ void __launch_bounds__(kThreads)
tiled_fwd_train_span_kernel(const int* __restrict__ starts,
                            const int* __restrict__ counts,
                            const int* __restrict__ offsets,
                            const float* __restrict__ rows16,
                            float* __restrict__ out, float* __restrict__ tb,
                            int tw, int64_t b_pad, float bg0, float bg1,
                            float bg2, int tpp, int span_cap) {
  extern __shared__ __align__(128) float window[];
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  __shared__ uint64_t bar;
  composite::run_cluster_program(
      starts, counts, rows16, b_pad, tpp, span_cap, window, &bar,
      [&](int tile, auto stage) {
        composite::composite_tile_patched<PPT, true>(
            tile, starts, counts, offsets, rows16, out, tb, tw, b_pad, bg0,
            bg1, bg2, sh, boxes, stage);
      });
}

// K3's blocks an SM: the register cap of __launch_bounds__.
constexpr int kBwdBlocksPerSm = 2;

// One step of the reduce-scatter butterfly: lanes l and l ^ kOff hold the
// same n sums; the lower keeps the first ceil(n / 2), the upper the rest
// (a zero in its last slot when n is odd), each adding the partner's copy.
template <int N, int kOff>
__device__ __forceinline__ void scatter_step(float* v, int lane) {
  constexpr int H = (N + 1) / 2;
  const bool upper = lane & kOff;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float hi = k < N - H ? v[H + k] : 0.0f;
    const float recv =
        __shfl_xor_sync(0xffffffffu, upper ? v[k] : hi, kOff);
    v[k] = (upper ? hi : v[k]) + recv;
  }
}

// Sums the warp's ten per-lane sums: afterwards the lane that
// scatter_owner names holds sum k in v[0] (12 shuffles; the tree is
// fixed, so the result is deterministic).
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  static_assert(kSums == 10, "the butterfly's steps are written for ten sums");
  scatter_step<10, 16>(v, lane);
  scatter_step<5, 8>(v, lane);
  scatter_step<3, 4>(v, lane);
  scatter_step<2, 2>(v, lane);
  scatter_step<1, 1>(v, lane);
}

// The sum reduce_scatter leaves at `lane`, or -1. Every lane runs each step
// on the same number of slots; a lane's slots hold the sums [first, first +
// n) and zeros after them.
__device__ __forceinline__ int scatter_owner(int lane) {
  int first = 0, n = kSums, slots = kSums;
  for (int off = 16; off > 0; off /= 2) {
    const int h = (slots + 1) / 2;
    if (lane & off) {
      first += h;
      n = max(n - h, 0);
    } else {
      n = min(n, h);
    }
    slots = h;
  }
  return n == 1 ? first : -1;
}

// Two threads per live instance of the chunk, five sums each: add the warps
// that reduced the instance, in warp order, form the parameter gradients
// and store them (coalesced along the chunk).
__device__ __forceinline__ void store_reduced_grads(
    float (*red)[kWarps][kChunk], unsigned (*reduced)[kChunk / 32],
    composite::ChunkRows rows, float* __restrict__ grads, int64_t b_pad,
    int64_t base, int lo, int hi) {
  using namespace composite;
  const int j = threadIdx.x % kChunk;
  const int half = threadIdx.x / kChunk;  // sums 0..4 or 5..9
  if (j < lo || j >= hi) return;
  float t[kSums / 2];
#pragma unroll
  for (int k = 0; k < kSums / 2; ++k) t[k] = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (!((reduced[w][j / 32] >> (j % 32)) & 1u)) continue;
#pragma unroll
    for (int k = 0; k < kSums / 2; ++k) t[k] += red[half * 5 + k][w][j];
  }
  float* g = grads + base + j;
  if (half == 0) {  // dpow, dpow dx, dpow dy, dpow dx^2, dpow dy^2
    const float ca = rows[kA][j], cb = rows[kB][j], cc = rows[kC][j];
    g[0 * b_pad] = ca * t[1] + cb * t[2];
    g[1 * b_pad] = cc * t[2] + cb * t[1];
    g[2 * b_pad] = -0.5f * t[3];
    g[4 * b_pad] = -0.5f * t[4];
    g[8 * b_pad] = t[0] / fmaxf(rows[kOp][j], 1e-30f);
  } else {  // dpow dx dy, w g_r, w g_g, w g_b, w g_dep
    g[3 * b_pad] = -t[0];
    g[5 * b_pad] = t[1];
    g[6 * b_pad] = t[2];
    g[7 * b_pad] = t[3];
    g[9 * b_pad] = t[4];
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
tiled_bwd_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
                 const int* __restrict__ offsets,
                 const float* __restrict__ rows16,
                 const float* __restrict__ gimg, const float* __restrict__ tb,
                 float* __restrict__ grads, int tw, int64_t b_pad, float bg0,
                 float bg1, float bg2) {
  using namespace composite;
  using M = PatchMap<PPT>;
  constexpr int kQ = M::kQ;
  constexpr int p = M::kTile * M::kTile;
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  __shared__ float red[kSums][kWarps][kChunk];
  __shared__ unsigned reduced[kWarps][kChunk / 32];

  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const float* tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int owner = scatter_owner(lane);

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

  float gr[PPT], gg[PPT], gb[PPT], gd[PPT], kk[PPT], u_tot[PPT], carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const float* g =
        gimg + (static_cast<int64_t>(tile) * p + patch_pixel<PPT>(warp, lane, i)) * 8;
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
      T[i] = tb_tile[static_cast<int64_t>(ci) * p + patch_pixel<PPT>(warp, lane, i)];
      started |= T[i] > 0.0f;
    }
    // barrier (the previous chunk's reduction has read sh, boxes, red and
    // reduced) and the vote: a chunk K2 never started has an all-zero
    // boundary, and so has every later chunk of the tile; their slots keep
    // the wrapper's zeros
    if (!__syncthreads_or(started)) break;
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    load_chunk_boxes(sh, boxes, rows16, b_pad, base);
    __syncthreads();

    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    // the live instances whose box meets the warp's patch, 32 per word
    unsigned hit[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k * 32 + lane;
      const float4 b = boxes[j];
      hit[k] = __ballot_sync(0xffffffffu, j >= lo && j < hi &&
                                              b.x <= patch_x1 && b.y >= patch_x0 &&
                                              b.z <= patch_y1 && b.w >= patch_y0);
    }

    float rem[PPT], cum[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      rem[i] = u_tot[i] - carry[i];
      cum[i] = 0.0f;
    }
    // bit k of `mine`: this warp reduced instance 32 k + lane
    unsigned mine = 0u;
    int word_base = 0;
    unsigned m = hit[0], m1 = hit[1], m2 = hit[2], m3 = hit[3];
    while (true) {
      if (m == 0u) {
        if ((m1 | m2 | m3) == 0u) break;
        m = m1;
        m1 = m2;
        m2 = m3;
        m3 = 0u;
        word_base += 32;
        continue;
      }
      const int j = word_base + __ffs(m) - 1;
      m &= m - 1u;
      const float gx = sh[kX][j], gy = sh[kY][j];
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
      const float op = sh[kOp][j], dep = sh[kDepth][j], cut = sh[kCut][j];
      // classify the lane's pixels first, then run their terms without a
      // branch: a dead pixel takes alpha = 0 and offsets 0, so its T, prefix
      // and sums change by exact zeros (also when the instance's mean is not
      // finite), and the pixels' chains interleave
      bool live[PPT];
      float a_raw[PPT], alpha[PPT];
      bool seen = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        live[i] = splat_alpha(qx[i % kQ] - gx, qy[i / kQ] - gy, ca, cb, cc, op,
                              cut, &a_raw[i], &alpha[i]);
        seen |= live[i];
      }
      if (!__any_sync(0xffffffffu, seen)) continue;
      float s[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) s[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = live[i] ? qx[i % kQ] - gx : 0.0f;
        const float dy = live[i] ? qy[i / kQ] - gy : 0.0f;
        const float al = live[i] ? alpha[i] : 0.0f;
        const float ar = live[i] ? a_raw[i] : 0.0f;
        const float w = al * T[i];
        const float u = gr[i] * cr + gg[i] * cg + gb[i] * cbl + gd[i] * dep;
        cum[i] += u * w;
        pair_grad(s, dx, dy, ar, al, T[i], w, u, kk[i], rem[i] - cum[i],
                  gr[i], gg[i], gb[i], gd[i]);
        T[i] *= 1.0f - al;
      }
      reduce_scatter(s, lane);
      if (owner >= 0) red[owner][warp][j] = s[0];
      if (lane == j % 32) mine |= 1u << (j / 32);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned r = __ballot_sync(0xffffffffu, (mine >> k) & 1u);
      if (lane == k) reduced[warp][k] = r;
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) carry[i] += cum[i];
    __syncthreads();
    store_reduced_grads(red, reduced, const_cast<ChunkRows>(sh), grads, b_pad,
                        base, lo, hi);
  }
}

// Calls fn(j) for each instance j of the 4 hit words, in ascending lane
// order: K3's loop, the words rotated through registers (a loop over the
// words that indexes them puts them in local memory).
template <typename Fn>
__device__ __forceinline__ void for_each_hit(const unsigned (&hit)[4], Fn fn) {
  int word_base = 0;
  unsigned m = hit[0], m1 = hit[1], m2 = hit[2], m3 = hit[3];
  while (true) {
    if (m == 0u) {
      if ((m1 | m2 | m3) == 0u) break;
      m = m1;
      m1 = m2;
      m2 = m3;
      m3 = 0u;
      word_base += 32;
      continue;
    }
    const int j = word_base + __ffs(m) - 1;
    m &= m - 1u;
    fn(j);
  }
}

// K4: the reverse sweep of one tile with K3's patched, culled walk; `stage`
// puts each chunk's rows and boxes in sh and boxes (from rows16, or from
// the cluster's window).
template <int PPT, typename Stage>
__device__ __forceinline__ void reverse_tile(
    int tile, const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ offsets, const float* __restrict__ rows16,
    const float* __restrict__ gimg, const float* __restrict__ tb,
    float* __restrict__ grads, int tw, int64_t b_pad, float bg0, float bg1,
    float bg2, float (*sh)[kChunk], float4* boxes,
    float (*red)[kWarps][kChunk], unsigned (*reduced)[kChunk / 32],
    Stage stage) {
  using namespace composite;
  using M = PatchMap<PPT>;
  constexpr int kQ = M::kQ;
  constexpr int p = M::kTile * M::kTile;
  const int start = starts[tile];
  const int count = counts[tile];
  const int kt = start / kChunk;
  const int n_chunks = (start - kt * kChunk + count + kChunk - 1) / kChunk;
  const float* tb_tile = tb + static_cast<int64_t>(offsets[tile]) * p;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int owner = scatter_owner(lane);

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

  float gr[PPT], gg[PPT], gb[PPT], gd[PPT], kk[PPT], s_carry[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const float* g =
        gimg + (static_cast<int64_t>(tile) * p + patch_pixel<PPT>(warp, lane, i)) * 8;
    gr[i] = g[0];
    gg[i] = g[1];
    gb[i] = g[2];
    gd[i] = g[3];
    kk[i] = (g[4] - (gr[i] * bg0 + gg[i] * bg1 + gb[i] * bg2)) * (1.0f - g[5]);
    s_carry[i] = 0.0f;
  }

  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const float* tb_chunk = tb_tile + static_cast<int64_t>(ci) * p;
    float T[PPT];
    bool started = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = tb_chunk[patch_pixel<PPT>(warp, lane, i)];
      started |= T[i] > 0.0f;
    }
    // barrier (the previous chunk's reduction has read sh, boxes, red and
    // reduced) and the vote: an all-zero boundary marks a chunk the forward
    // never started; its slots keep the wrapper's zeros and the carry stays
    if (!__syncthreads_or(started)) continue;
    const int64_t base = static_cast<int64_t>(kt + ci) * kChunk;
    stage(sh, boxes, rows16, b_pad, base);
    __syncthreads();

    const int lo = chunk_lo(start, kt, ci);
    const int hi = min(static_cast<int>(start + count - base), kChunk);
    // the live instances whose box meets the warp's patch, 32 per word;
    // both passes walk these, in ascending lane order
    unsigned hit[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k * 32 + lane;
      const float4 b = boxes[j];
      hit[k] = __ballot_sync(0xffffffffu, j >= lo && j < hi &&
                                              b.x <= patch_x1 && b.y >= patch_x0 &&
                                              b.z <= patch_y1 && b.w >= patch_y0);
    }

    // pass 1: the chunk's total of u w per pixel. A dead pixel takes alpha
    // = 0, which changes its T and total by exact zeros; a warp none of
    // whose pixels sees the instance skips it, in both passes.
    float total[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) total[i] = 0.0f;
    for_each_hit(hit, [&](int j) {
      const float gx = sh[kX][j], gy = sh[kY][j];
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      const float op = sh[kOp][j], cut = sh[kCut][j];
      bool live[PPT];
      float alpha[PPT];
      bool seen = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float a_raw;
        live[i] = splat_alpha(qx[i % kQ] - gx, qy[i / kQ] - gy, ca, cb, cc, op,
                              cut, &a_raw, &alpha[i]);
        seen |= live[i];
      }
      if (!__any_sync(0xffffffffu, seen)) return;
      const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
      const float dep = sh[kDepth][j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float al = live[i] ? alpha[i] : 0.0f;
        const float w = al * T[i];
        const float u = gr[i] * cr + gg[i] * cg + gb[i] * cbl + gd[i] * dep;
        total[i] += u * w;
        T[i] *= 1.0f - al;
      }
    });

    // pass 2: the same pairs again, now with S_i known
    float cum[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      T[i] = tb_chunk[patch_pixel<PPT>(warp, lane, i)];
      cum[i] = 0.0f;
    }
    // bit k of `mine`: this warp reduced instance 32 k + lane
    unsigned mine = 0u;
    for_each_hit(hit, [&](int j) {
      const float gx = sh[kX][j], gy = sh[kY][j];
      const float ca = sh[kA][j], cb = sh[kB][j], cc = sh[kC][j];
      const float op = sh[kOp][j], cut = sh[kCut][j];
      bool live[PPT];
      float a_raw[PPT], alpha[PPT];
      bool seen = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        live[i] = splat_alpha(qx[i % kQ] - gx, qy[i / kQ] - gy, ca, cb, cc, op,
                              cut, &a_raw[i], &alpha[i]);
        seen |= live[i];
      }
      if (!__any_sync(0xffffffffu, seen)) return;
      const float cr = sh[kR][j], cg = sh[kG][j], cbl = sh[kBl][j];
      const float dep = sh[kDepth][j];
      float s[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) s[q] = 0.0f;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = live[i] ? qx[i % kQ] - gx : 0.0f;
        const float dy = live[i] ? qy[i / kQ] - gy : 0.0f;
        const float al = live[i] ? alpha[i] : 0.0f;
        const float ar = live[i] ? a_raw[i] : 0.0f;
        const float w = al * T[i];
        const float u = gr[i] * cr + gg[i] * cg + gb[i] * cbl + gd[i] * dep;
        cum[i] += u * w;
        pair_grad(s, dx, dy, ar, al, T[i], w, u, kk[i],
                  (total[i] - cum[i]) + s_carry[i], gr[i], gg[i], gb[i], gd[i]);
        T[i] *= 1.0f - al;
      }
      reduce_scatter(s, lane);
      if (owner >= 0) red[owner][warp][j] = s[0];
      if (lane == j % 32) mine |= 1u << (j / 32);
    });
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned r = __ballot_sync(0xffffffffu, (mine >> k) & 1u);
      if (lane == k) reduced[warp][k] = r;
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) s_carry[i] += total[i];
    __syncthreads();
    store_reduced_grads(red, reduced, const_cast<ChunkRows>(sh), grads, b_pad,
                        base, lo, hi);
  }
}

// K4: the reverse sweep of this CTA's tile, from the cluster's window when
// its program fits (composite.cuh::run_cluster_program). Registers capped
// for K3's blocks an SM.
template <int PPT>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
tiled_bwd_reverse_kernel(const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         const int* __restrict__ offsets,
                         const float* __restrict__ rows16,
                         const float* __restrict__ gimg,
                         const float* __restrict__ tb, float* __restrict__ grads,
                         int tw, int64_t b_pad, float bg0, float bg1, float bg2,
                         int tpp, int span_cap) {
  using namespace composite;
  extern __shared__ __align__(128) float window[];
  __shared__ float sh[kRows][kChunk];
  __shared__ float4 boxes[kChunk];
  __shared__ float red[kSums][kWarps][kChunk];
  __shared__ unsigned reduced[kWarps][kChunk / 32];
  __shared__ uint64_t bar;
  run_cluster_program(
      starts, counts, rows16, b_pad, tpp, span_cap, window, &bar,
      [&](int tile, auto stage) {
        reverse_tile<PPT>(tile, starts, counts, offsets, rows16, gimg, tb,
                          grads, tw, b_pad, bg0, bg1, bg2, sh, boxes, red,
                          reduced, stage);
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
        a.st, a.ct, a.of, a.rows, o, t, tw, b_pad, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_fwd_train_kernel<1><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, o, t, tw, b_pad, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K2 that one SM holds at once at `tile_size`, as the runtime's
// occupancy calculator counts them from the kernel's registers and shared
// memory; -1 for an unsupported tile_size or a runtime error.
extern "C" int tiled_fwd_train_blocks_per_sm(int tile_size) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (tile_size == 32)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tiled_fwd_train_kernel<4>, kThreads, 0);
  else if (tile_size == 16)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tiled_fwd_train_kernel<1>, kThreads, 0);
  return err == cudaSuccess ? n : -1;
}

// Launches K2-span on `stream`: as tiled_fwd_train_launch, with n_tiles
// CTAs in clusters of composite::span_cluster_size(tpp) and a window of
// span_cap chunks spread over each cluster (1 <= span_cap <= b_pad / 128,
// tpp dividing n_tiles). Returns the CUDA error of the attribute call or of
// the cluster launch (cudaErrorInvalidValue for arguments it cannot take).
extern "C" int tiled_fwd_train_span_launch(
    const void* starts, const void* counts, const void* offsets,
    const void* rows16, void* out, void* tb, int n_tiles, int tw, int64_t b_pad,
    int tile_size, float bg0, float bg1, float bg2, int tpp, int span_cap,
    void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap) ||
      !composite::bulk_rows_ok(rows16, b_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(tb);
  if (tile_size == 32)
    return composite::launch_span_cluster(tiled_fwd_train_span_kernel<4>, n_tiles,
                                          tpp, span_cap, a.s, a.st, a.ct, a.of,
                                          a.rows, o, t, tw, b_pad, bg0, bg1, bg2);
  if (tile_size == 16)
    return composite::launch_span_cluster(tiled_fwd_train_span_kernel<1>, n_tiles,
                                          tpp, span_cap, a.s, a.st, a.ct, a.of,
                                          a.rows, o, t, tw, b_pad, bg0, bg1, bg2);
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
        a.st, a.ct, a.of, a.rows, gi, t, g, tw, b_pad, bg0, bg1, bg2);
  } else if (tile_size == 16) {
    tiled_bwd_kernel<1><<<n_tiles, kThreads, 0, a.s>>>(
        a.st, a.ct, a.of, a.rows, gi, t, g, tw, b_pad, bg0, bg1, bg2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K4 on `stream`: K3's arguments (gimg's U_tot column is not
// read), with n_tiles CTAs in clusters of composite::span_cluster_size(tpp)
// and a window of span_cap chunks spread over each cluster, beside each
// CTA's 40 KB of reduction scratch. The caller zeroes grads.
extern "C" int tiled_bwd_reverse_launch(
    const void* starts, const void* counts, const void* offsets,
    const void* rows16, const void* gimg, const void* tb, void* grads,
    int n_tiles, int tw, int64_t b_pad, int tile_size, float bg0, float bg1,
    float bg2, int tpp, int span_cap, void* stream) {
  if (n_tiles <= 0) return 0;
  if (!composite::span_args_ok(n_tiles, b_pad, tpp, span_cap) ||
      !composite::bulk_rows_ok(rows16, b_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = unpack(starts, counts, offsets, rows16, stream);
  const float* gi = static_cast<const float*>(gimg);
  const float* t = static_cast<const float*>(tb);
  float* g = static_cast<float*>(grads);
  if (tile_size == 32)
    return composite::launch_span_cluster(tiled_bwd_reverse_kernel<4>, n_tiles,
                                          tpp, span_cap, a.s, a.st, a.ct, a.of,
                                          a.rows, gi, t, g, tw, b_pad, bg0, bg1,
                                          bg2);
  if (tile_size == 16)
    return composite::launch_span_cluster(tiled_bwd_reverse_kernel<1>, n_tiles,
                                          tpp, span_cap, a.s, a.st, a.ct, a.of,
                                          a.rows, gi, t, g, tw, b_pad, bg0, bg1,
                                          bg2);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The occupancy of K2-span (kernel 0) or K4 (kernel 1) launched on n_tiles
// tiles of `tile_size` with (tpp, span_cap): out[0] blocks an SM, out[1]
// clusters resident on the card at once, out[2] the cluster size. Returns
// the CUDA error (cudaErrorInvalidValue for an unsupported kernel or
// tile_size).
extern "C" int tiled_train_span_occupancy(int kernel, int tile_size, int n_tiles,
                                          int tpp, int span_cap, int* out) {
  if (kernel == 0 && tile_size == 32)
    return composite::span_cluster_occupancy(tiled_fwd_train_span_kernel<4>,
                                             n_tiles, tpp, span_cap, out);
  if (kernel == 0 && tile_size == 16)
    return composite::span_cluster_occupancy(tiled_fwd_train_span_kernel<1>,
                                             n_tiles, tpp, span_cap, out);
  if (kernel == 1 && tile_size == 32)
    return composite::span_cluster_occupancy(tiled_bwd_reverse_kernel<4>,
                                             n_tiles, tpp, span_cap, out);
  if (kernel == 1 && tile_size == 16)
    return composite::span_cluster_occupancy(tiled_bwd_reverse_kernel<1>,
                                             n_tiles, tpp, span_cap, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
