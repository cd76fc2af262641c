// The adjoint of the point front end (point_front.cu's FreeXyz pass): from
// the cotangents of its outputs xy [n, 2], depth [n], conic [n, 3], color
// [n, 3] and opacity [n], the gradients of its inputs xyz [n, 3],
// features_dc [n, 1, 3], features_rest [n, K-1, 3], the log-scales [n, 3],
// the WXYZ rotation [n, 4] and the opacity logit [n, 1], in one pass.
// Python wrapper ops/point_front.py (project_points_backward_fused, the
// backward of its autograd function); plain PyTorch version
// ops/point_front.py::project_points_backward_plain.
//
// It replaces no TPU kernel: the JAX package differentiates its front end
// (models/point_gaussians.py::project_points_view, XLA) by autodiff. It was
// added because training on the card ran the front end as ~370 PyTorch ops
// and autograd walked them back over every slot of the field (each SH
// coefficient's slice zero-filled into a full [n, 16, 3] gradient and
// summed): ~60-80 ms an iteration of fit-gs360 against ~1 ms of bytes.
//
// What it computes, per Gaussian g: nothing is saved by the forward but
// its valid mask; the pass recomputes what it needs from the parameters
// with the forward's own functions (front.cuh), so each branch is the one
// the forward took, and applies the chain rule backwards through the EWA
// projection, the projected mean, the covariance, the quaternion's
// normalization, the SH colour and the view direction. At ties it follows
// autograd: a clamp passes the gradient at its bound (the colour's at 0,
// txtz's and tytz's at +-lim, the view norm's at 1e-8), torch.where gives
// none to the side it did not select (tz and det inside their guards, the
// depth of an invalid Gaussian), and ceil gives none (radius and power_cut
// carry no gradient). The SH basis's derivatives come from forward-mode
// differentiation of sh_basis itself (Dual below). A Gaussian whose
// cotangents are all zero gets exact zeros without its parameters being
// read (dead slots, invalid Gaussians, those no pixel reached), and so do
// the SH coefficients above the degree.
//
// What bounds it on the H100: bytes. A Gaussian with a cotangent reads its
// 59-float row, a 10-float cotangent row (as autograd hands it over: views
// of the rasterizer's [n, 16] per-Gaussian rows, two 32-byte sectors) and a
// byte, and writes 59 floats (~537 B); one without reads the cotangents
// and writes zeros (~301 B). At 3.5M slots that is at most 1.9 GB, 0.56 ms
// at 3.35 TB/s, against ~800 fp32 operations a Gaussian (~0.04 ms).
//
// What the design does about it: the forward's layout. Each warp owns 32
// consecutive Gaussians and stages their rows of each input through shared
// memory at odd strides (16-byte loads where the warp's rows are whole and
// aligned, scalar coalesced loads of the strided cotangent views, which
// stay in L1 for the next field of the same rows). A warp whose 32
// cotangent rows are all zero reads no parameter and stores zeros; one with
// fewer than kDenseRows Gaussians with a cotangent reads their rows alone
// (a training view reaches ~8% of the slots of fit-gs360's field, so most
// warps read 2-3 rows instead of 32), one with more stages all 32. Each
// lane computes its Gaussian's gradients into the rows it read, and the
// warp stores them back as flat, coalesced 16-byte stores. Blocks of 4
// warps, no block-wide barrier.

#include <cstdint>
#include <cuda_runtime.h>

#include "front.cuh"

namespace {

using namespace front;
// the float forms beside the Dual overloads below
using front::add;
using front::mul;
using front::sub;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// a warp with fewer reached Gaussians fetches their parameter rows alone;
// from this many on it stages all 32 rows with coalesced loads
constexpr int kDenseRows = 6;

struct BwdArgs {
  const float* xyz;         // [n, 3]
  const float* fdc;         // [n, 1, 3]
  const float* frest;       // [n, rest_stride / 3, 3]
  const float* scaling;     // [n, 3] log-scales
  const float* rotation;    // [n, 4]
  const float* opacity;     // [n, 1] logits
  const bool* valid;        // [n]: the forward's
  const float* world_view;  // [4, 4] row-vector transform
  const float* full_proj;   // [4, 4]
  const float* center;      // [3]
  int64_t n;
  int rest_stride;          // floats of features_rest a Gaussian: (K-1) * 3
  float width, height, focal_x, focal_y, lim_x, lim_y;
  // the cotangents, each row's floats adjacent, rows *_stride floats apart
  const float* g_xy;
  const float* g_depth;
  const float* g_conic;
  const float* g_color;
  const float* g_opacity;
  int xy_stride, depth_stride, conic_stride, color_stride, opacity_stride;
  // the gradients, contiguous, shaped as the inputs
  float* d_xyz;
  float* d_fdc;
  float* d_frest;
  float* d_scaling;
  float* d_rotation;
  float* d_opacity;
};

// A value and its derivatives with respect to the unit view direction (x,
// y, z): sh_basis on Duals gives each basis term with its gradient. The
// value is rounded as the forward rounds it; the derivatives are plain
// float arithmetic.
struct Dual {
  float v, dx, dy, dz;
  __device__ explicit Dual(float c) : v(c), dx(0.0f), dy(0.0f), dz(0.0f) {}
  __device__ Dual(float c, float a, float b, float d) : v(c), dx(a), dy(b), dz(d) {}
};

__device__ __forceinline__ Dual mul(Dual a, Dual b) {
  return Dual(mul(a.v, b.v), a.dx * b.v + a.v * b.dx, a.dy * b.v + a.v * b.dy,
              a.dz * b.v + a.v * b.dz);
}
__device__ __forceinline__ Dual mul(Dual a, float s) {
  return Dual(mul(a.v, s), a.dx * s, a.dy * s, a.dz * s);
}
__device__ __forceinline__ Dual add(Dual a, Dual b) {
  return Dual(add(a.v, b.v), a.dx + b.dx, a.dy + b.dy, a.dz + b.dz);
}
__device__ __forceinline__ Dual add(Dual a, float s) {
  return Dual(add(a.v, s), a.dx, a.dy, a.dz);
}
__device__ __forceinline__ Dual sub(Dual a, Dual b) {
  return Dual(sub(a.v, b.v), a.dx - b.dx, a.dy - b.dy, a.dz - b.dz);
}
__device__ __forceinline__ Dual sub(Dual a, float s) {
  return Dual(sub(a.v, s), a.dx, a.dy, a.dz);
}

// The cotangents of one Gaussian's outputs
struct Cotangents {
  float xy[2], depth, conic[3], color[3], opacity;
};

// The gradients of one Gaussian's mean and quaternion, beside those the
// pass writes to its staged rows
struct MeanGrads {
  float xyz[3], quat[4];
};

// The adjoint of the front end for one Gaussian at the mean (x, y, z) with
// quaternion q (as stored), its staged rows dc (3 floats), rest (the
// degree's coefficients, rows of 3) and log-scales ls (3): the gradients of
// the mean and the quaternion in m, of dc, rest and ls in place of their
// rows, and of the opacity logit o returned. A prologue that places the
// mean and quaternion (a mesh-anchored field's) can take m on to its own
// inputs.
template <int DEG>
__device__ __forceinline__ float adjoint(const BwdArgs& a, float x, float y,
                                         float z, const float q_raw[4],
                                         float* dc, float* rest, float* ls,
                                         float o, const Cotangents& ct,
                                         MeanGrads& m) {
  const float* wv = a.world_view;
  const float* fp = a.full_proj;

  // the forward, recomputed
  float q[4] = {q_raw[0], q_raw[1], q_raw[2], q_raw[3]};
  const float inv = quat_normalize(q);
  float r[3][3], s2[3], cov[6];
  quat_rotmat(q, r);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = expf(ls[k]);
    s2[k] = mul(s, s);
  }
  covariance(s2, r, cov);
  const ScreenMean sm = screen_mean(x, y, z, wv, fp, a.width, a.height);
  Ewa e;
  ewa(sm.t0, sm.t1, sm.tz, cov, wv, a.focal_x, a.focal_y, a.lim_x, a.lim_y, e);

  // conic = (c11, -c01, c00) / det_safe; det_safe = det outside |det| < 1e-12
  const float g_inv_det = ct.conic[0] * e.c11 - ct.conic[1] * e.c01 +
                          ct.conic[2] * e.c00;
  const float g_det = fabsf(e.det) < F(1e-12)
                          ? 0.0f
                          : -g_inv_det * e.inv_det * e.inv_det;
  const float g_c00 = ct.conic[2] * e.inv_det + g_det * e.c11;
  const float g_c11 = ct.conic[0] * e.inv_det + g_det * e.c00;
  const float g_c01 = -ct.conic[1] * e.inv_det - 2.0f * g_det * e.c01;

  // c00 = a0 cov a0, c01 = a1 cov a0, c11 = a1 cov a1 (t = cov a0, u = cov a1)
  float g_cov[6];
  {
    auto gc = [&](int i, int j) {
      return g_c00 * e.a0[i] * e.a0[j] + g_c01 * e.a1[i] * e.a0[j] +
             g_c11 * e.a1[i] * e.a1[j];
    };
    g_cov[0] = gc(0, 0);
    g_cov[1] = gc(0, 1) + gc(1, 0);
    g_cov[2] = gc(0, 2) + gc(2, 0);
    g_cov[3] = gc(1, 1);
    g_cov[4] = gc(1, 2) + gc(2, 1);
    g_cov[5] = gc(2, 2);
  }
  float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g_a0 = 2.0f * g_c00 * e.t[k] + g_c01 * e.u[k];
    const float g_a1 = g_c01 * e.t[k] + 2.0f * g_c11 * e.u[k];
    g_j00 += g_a0 * __ldg(wv + 4 * k);
    g_j02 += g_a0 * __ldg(wv + 4 * k + 2);
    g_j11 += g_a1 * __ldg(wv + 4 * k + 1);
    g_j12 += g_a1 * __ldg(wv + 4 * k + 2);
  }
  // j00 = inv_z fx, j02 = -fx tx inv_z^2, j11 = inv_z fy, j12 = -fy ty inv_z^2
  const float fx = a.focal_x, fy = a.focal_y;
  const float g_inv_z2 = -(g_j02 * e.tx * fx + g_j12 * e.ty * fy);
  const float g_inv_z = g_j00 * fx + g_j11 * fy + 2.0f * e.inv_z * g_inv_z2;
  const float g_tx = -g_j02 * fx * e.inv_z2, g_ty = -g_j12 * fy * e.inv_z2;
  // tx = clamp(t0 / tz_safe, +-lim) tz_safe; the clamp passes at its bounds
  float g_tzs = -g_inv_z * e.inv_z * e.inv_z + g_tx * e.txtz + g_ty * e.tytz;
  const float g_rx = e.rx >= -a.lim_x && e.rx <= a.lim_x ? g_tx * e.tz_safe : 0.0f;
  const float g_ry = e.ry >= -a.lim_y && e.ry <= a.lim_y ? g_ty * e.tz_safe : 0.0f;
  const float g_t0 = g_rx / e.tz_safe, g_t1 = g_ry / e.tz_safe;
  g_tzs -= (g_rx * e.rx + g_ry * e.ry) / e.tz_safe;
  // tz_safe = tz outside |tz| < 1e-6; depth = tz where valid (ct.depth is 0
  // elsewhere)
  const float g_tz = (fabsf(sm.tz) < F(1e-6) ? 0.0f : g_tzs) + ct.depth;
  // px = ((h0 p_w + 1) W) / 2 - 1/2, py alike, p_w = 1 / (h3 + 1e-7)
  const float hw = 0.5f * a.width, hh = 0.5f * a.height;
  const float g_h0 = ct.xy[0] * hw * sm.p_w, g_h1 = ct.xy[1] * hh * sm.p_w;
  const float g_pw = ct.xy[0] * hw * sm.h0 + ct.xy[1] * hh * sm.h1;
  const float g_h3 = -g_pw * sm.p_w * sm.p_w;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    m.xyz[j] = g_t0 * __ldg(wv + 4 * j) + g_t1 * __ldg(wv + 4 * j + 1) +
               g_tz * __ldg(wv + 4 * j + 2) + g_h0 * __ldg(fp + 4 * j) +
               g_h1 * __ldg(fp + 4 * j + 1) + g_h3 * __ldg(fp + 4 * j + 3);

  // cov = R diag(s2) R^T: with M = g_cov as a symmetric matrix, its diagonal
  // doubled, g_R = M R diag(s2) and g_s2[k] = (R^T M R)[k][k] / 2
  const float mm[3][3] = {{2.0f * g_cov[0], g_cov[1], g_cov[2]},
                          {g_cov[1], 2.0f * g_cov[3], g_cov[4]},
                          {g_cov[2], g_cov[4], 2.0f * g_cov[5]}};
  float g_r[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[i] = mm[i][0] * r[0][k] + mm[i][1] * r[1][k] + mm[i][2] * r[2][k];
      g_r[i][k] = s2[k] * w[i];
    }
    const float g_s2 = 0.5f * (r[0][k] * w[0] + r[1][k] * w[1] + r[2][k] * w[2]);
    // s2 = exp(ls)^2
    ls[k] = 2.0f * g_s2 * s2[k];
  }
  // quat_to_rotmat's partial derivatives, then the normalization:
  // g_q = inv (g_qn - (g_qn . qn) qn)
  {
    const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
    float g_qn[4];
    g_qn[0] = 2.0f * (-qz * g_r[0][1] + qy * g_r[0][2] + qz * g_r[1][0] -
                      qx * g_r[1][2] - qy * g_r[2][0] + qx * g_r[2][1]);
    g_qn[1] = 2.0f * (qy * g_r[0][1] + qz * g_r[0][2] + qy * g_r[1][0] -
                      2.0f * qx * g_r[1][1] - w * g_r[1][2] + qz * g_r[2][0] +
                      w * g_r[2][1] - 2.0f * qx * g_r[2][2]);
    g_qn[2] = 2.0f * (-2.0f * qy * g_r[0][0] + qx * g_r[0][1] + w * g_r[0][2] +
                      qx * g_r[1][0] + qz * g_r[1][2] - w * g_r[2][0] +
                      qz * g_r[2][1] - 2.0f * qy * g_r[2][2]);
    g_qn[3] = 2.0f * (-2.0f * qz * g_r[0][0] - w * g_r[0][1] + qx * g_r[0][2] +
                      w * g_r[1][0] - 2.0f * qz * g_r[1][1] + qy * g_r[1][2] +
                      qx * g_r[2][0] + qy * g_r[2][1]);
    const float dot = g_qn[0] * w + g_qn[1] * qx + g_qn[2] * qy + g_qn[3] * qz;
#pragma unroll
    for (int k = 0; k < 4; ++k) m.quat[k] = inv * (g_qn[k] - dot * q[k]);
  }

  // SH colour: color_c = max(sum_k b_k sh_kc + 0.5, 0), summed as the
  // forward sums it; the clamp passes at 0. Then the basis again, streamed
  // term by term with its derivatives (no array of them in registers).
  const ViewDir vd = view_dir(x, y, z, a.center);
  float gv[3];
  {
    float b[(DEG + 1) * (DEG + 1)];
    sh_basis<DEG>(vd.u[0], vd.u[1], vd.u[2], b);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      gv[c] = add(sh_sum<DEG>(b, dc, rest, c), 0.5f) >= 0.0f ? ct.color[c] : 0.0f;
  }
  float g_u[3] = {0.0f, 0.0f, 0.0f};
  sh_terms<DEG>(Dual(vd.u[0], 1.0f, 0.0f, 0.0f), Dual(vd.u[1], 0.0f, 1.0f, 0.0f),
                Dual(vd.u[2], 0.0f, 0.0f, 1.0f), [&](int k, Dual b) {
    float* row = k == 0 ? dc : rest + (k - 1) * 3;
    const float g_b = row[0] * gv[0] + row[1] * gv[1] + row[2] * gv[2];
    g_u[0] += g_b * b.dx;
    g_u[1] += g_b * b.dy;
    g_u[2] += g_b * b.dz;
#pragma unroll
    for (int c = 0; c < 3; ++c) row[c] = b.v * gv[c];
  });
  // u = d / max(|d|, 1e-8): the norm's clamp passes at 1e-8
  const float g_nrm = -(g_u[0] * vd.u[0] + g_u[1] * vd.u[1] + g_u[2] * vd.u[2]) / vd.nrm;
  const bool through = vd.len >= F(1e-8);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    m.xyz[j] += g_u[j] / vd.nrm + (through ? g_nrm * vd.d[j] / vd.len : 0.0f);

  // opacity = sigmoid(o)
  const float op = div(1.0f, add(1.0f, expf(-o)));
  return ct.opacity * op * (1.0f - op);
}

// Zeros the rows of Gaussians [g0, g0 + count) of the contiguous dst
// [n, stride]: 16-byte stores where the warp's rows are whole (dst + g0 *
// stride is then 16-byte aligned)
__device__ __forceinline__ void zero_rows(float* __restrict__ dst, int64_t g0,
                                          int count, int stride, int lane) {
  float* base = dst + g0 * stride;
  const int len = count * stride;
  if (count == 32 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int v = lane; v < len / 4; v += 32)
      __stcs(reinterpret_cast<float4*>(base) + v, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  } else {
    for (int e = lane; e < len; e += 32) base[e] = 0.0f;
  }
}

// Writes the staged rows (SS floats apart in src) of Gaussians [g0, g0 +
// count), USED floats each, to the contiguous dst [n, stride], zeros in the
// columns from USED on; flat and coalesced, 16-byte stores where the warp's
// rows are whole
template <int USED, int SS>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src,
                                           int64_t g0, int count, int stride,
                                           int lane) {
  if constexpr (USED == 0) {
    zero_rows(dst, g0, count, stride, lane);
  } else if (stride == USED) {
    float* base = dst + g0 * USED;
    if (count == 32 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      for (int v = lane; v < 8 * USED; v += 32) {
        float vals[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * v + k;
          vals[k] = src[(e / USED) * SS + e % USED];
        }
        __stcs(reinterpret_cast<float4*>(base) + v,
               make_float4(vals[0], vals[1], vals[2], vals[3]));
      }
    } else {
      for (int e = lane; e < count * USED; e += 32)
        base[e] = src[(e / USED) * SS + e % USED];
    }
  } else {
    // the rows of a field stored at a higher degree: (row, column) of
    // element e carried along, no division
    float* base = dst + g0 * stride;
    int r = 0, c = lane;
    while (c >= stride) {
      c -= stride;
      ++r;
    }
    for (int e = lane; e < count * stride; e += 32) {
      base[e] = c < USED ? src[r * SS + c] : 0.0f;
      c += 32;
      while (c >= stride) {
        c -= stride;
        ++r;
      }
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(kThreads, 4) point_front_bwd_kernel(BwdArgs a) {
  constexpr int kRest = rest_floats(DEG);
  constexpr int kRestSS = kRest ? odd_stride(kRest) : 0;
  // a warp's shared memory: rest rows, then positions, dc and log-scales (3
  // floats a row), the quaternions (4 at a stride of 5), and the cotangents
  // of xy (2 at a stride of 3), conic and color
  constexpr int kWarpFloats = 32 * kRestSS + 3 * 96 + 32 * 5 + 3 * 96;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_rest = reinterpret_cast<float*>(smem4) + warp * kWarpFloats;
  float* s_pos = s_rest + 32 * kRestSS;
  float* s_dc = s_pos + 96;
  float* s_sc = s_dc + 96;
  float* s_rot = s_sc + 96;
  float* s_gxy = s_rot + 160;
  float* s_gcon = s_gxy + 96;
  float* s_gcol = s_gcon + 96;

  const int64_t g0 = (int64_t(blockIdx.x) * kWarps + warp) * 32;
  if (g0 >= a.n) return;
  const int count = static_cast<int>(a.n - g0 < 32 ? a.n - g0 : 32);
  const int64_t g = g0 + lane;
  const bool live = lane < count;

  // the cotangents, and whether this Gaussian has any
  stage<2, 3, false>(s_gxy, a.g_xy, g0, count, a.xy_stride, lane);
  stage<3, 3, false>(s_gcon, a.g_conic, g0, count, a.conic_stride, lane);
  stage<3, 3, false>(s_gcol, a.g_color, g0, count, a.color_stride, lane);
  Cotangents ct = {};
  if (live) {
    ct.depth = a.valid[g] ? __ldg(a.g_depth + g * a.depth_stride) : 0.0f;
    ct.opacity = __ldg(a.g_opacity + g * a.opacity_stride);
  }
  __syncwarp();
  bool any = false;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k < 2) ct.xy[k] = s_gxy[lane * 3 + k];
      ct.conic[k] = s_gcon[lane * 3 + k];
      ct.color[k] = s_gcol[lane * 3 + k];
    }
    any = ct.xy[0] != 0.0f || ct.xy[1] != 0.0f || ct.depth != 0.0f ||
          ct.conic[0] != 0.0f || ct.conic[1] != 0.0f || ct.conic[2] != 0.0f ||
          ct.color[0] != 0.0f || ct.color[1] != 0.0f || ct.color[2] != 0.0f ||
          ct.opacity != 0.0f;
  }
  const int rest_stride = a.rest_stride;
  const unsigned reached = __ballot_sync(0xffffffffu, any);
  if (reached == 0u) {
    // no cotangent in the warp: zeros, no parameter read
    zero_rows(a.d_xyz, g0, count, 3, lane);
    zero_rows(a.d_fdc, g0, count, 3, lane);
    zero_rows(a.d_frest, g0, count, rest_stride, lane);
    zero_rows(a.d_scaling, g0, count, 3, lane);
    zero_rows(a.d_rotation, g0, count, 4, lane);
    if (live) a.d_opacity[g] = 0.0f;
    return;
  }

  if (__popc(reached) >= kDenseRows) {
    stage<3, 3>(s_pos, a.xyz, g0, count, 3, lane);
    stage<3, 3>(s_dc, a.fdc, g0, count, 3, lane);
    if constexpr (kRest > 0)
      stage<kRest, kRestSS>(s_rest, a.frest, g0, count, rest_stride, lane);
    stage<3, 3>(s_sc, a.scaling, g0, count, 3, lane);
    stage<4, 5>(s_rot, a.rotation, g0, count, 4, lane);
  } else {
    // the reached rows alone, one at a time: the warp's lanes read the
    // row's 13 + kRest floats (its sectors of each input) at once
    constexpr int kRowFloats = 13 + kRest;
    for (unsigned m = reached; m != 0u; m &= m - 1u) {
      const int r = __ffs(m) - 1;
      const int64_t gr = g0 + r;
#pragma unroll
      for (int f0 = 0; f0 < kRowFloats; f0 += 32) {
        const int f = f0 + lane;
        if (f >= kRowFloats) break;
        const float* src;
        float* dst;
        if (f < 3) {
          src = a.xyz + gr * 3 + f;
          dst = s_pos + r * 3 + f;
        } else if (f < 6) {
          src = a.fdc + gr * 3 + (f - 3);
          dst = s_dc + r * 3 + (f - 3);
        } else if (f < 6 + kRest) {
          src = a.frest + gr * rest_stride + (f - 6);
          dst = s_rest + r * kRestSS + (f - 6);
        } else if (f < 9 + kRest) {
          src = a.scaling + gr * 3 + (f - 6 - kRest);
          dst = s_sc + r * 3 + (f - 6 - kRest);
        } else {
          src = a.rotation + gr * 4 + (f - 9 - kRest);
          dst = s_rot + r * 5 + (f - 9 - kRest);
        }
        *dst = __ldcs(src);
      }
    }
  }
  __syncwarp();

  // each lane's gradients in place of its own staged rows
  float* pos = s_pos + lane * 3;
  float* rot = s_rot + lane * 5;
  float* dc = s_dc + lane * 3;
  float* rest = s_rest + lane * kRestSS;
  float* ls = s_sc + lane * 3;
  float g_o = 0.0f;
  if (any) {
    MeanGrads m;
    const float q[4] = {rot[0], rot[1], rot[2], rot[3]};
    g_o = adjoint<DEG>(a, pos[0], pos[1], pos[2], q, dc, rest, ls,
                       __ldcs(a.opacity + g), ct, m);
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = m.xyz[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) rot[k] = m.quat[k];
  } else if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pos[k] = dc[k] = ls[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) rot[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRest; ++k) rest[k] = 0.0f;
  }
  if (live) a.d_opacity[g] = g_o;
  __syncwarp();
  store_rows<3, 3>(a.d_xyz, s_pos, g0, count, 3, lane);
  store_rows<3, 3>(a.d_fdc, s_dc, g0, count, 3, lane);
  if (rest_stride > 0)
    store_rows<kRest, kRestSS>(a.d_frest, s_rest, g0, count, rest_stride, lane);
  store_rows<3, 3>(a.d_scaling, s_sc, g0, count, 3, lane);
  store_rows<4, 5>(a.d_rotation, s_rot, g0, count, 4, lane);
}

template <int DEG>
constexpr size_t smem_bytes() {
  constexpr int kRest = rest_floats(DEG);
  return sizeof(float) * kWarps *
         (32 * (kRest ? odd_stride(kRest) : 0) + 3 * 96 + 32 * 5 + 3 * 96);
}

}  // namespace

// Launches the point front end's backward on `stream` for n Gaussians at SH
// degree sh_degree (0-4): the forward's inputs (point_front_launch's xyz
// ... opacity, rest_stride, the camera and its scalars, all contiguous
// float32) and its bool valid [n] output; the cotangents of xy [n, 2],
// depth [n], conic [n, 3], color [n, 3] and opacity [n], each a float32
// array whose rows are *_stride floats apart and whose row's floats are
// adjacent; and the contiguous float32 gradients d_xyz [n, 3], d_fdc
// [n, 1, 3], d_frest [n, rest_stride / 3, 3], d_scaling [n, 3], d_rotation
// [n, 4] and d_opacity [n, 1], every float of which is written. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported degree).
extern "C" int point_front_bwd_launch(
    const void* xyz, const void* fdc, const void* frest, int rest_stride,
    const void* scaling, const void* rotation, const void* opacity,
    const void* valid, const void* world_view, const void* full_proj,
    const void* center, int64_t n, int sh_degree, int width, int height,
    float focal_x, float focal_y, float lim_x, float lim_y, const void* g_xy,
    int xy_stride, const void* g_depth, int depth_stride, const void* g_conic,
    int conic_stride, const void* g_color, int color_stride,
    const void* g_opacity, int opacity_stride, void* d_xyz, void* d_fdc,
    void* d_frest, void* d_scaling, void* d_rotation, void* d_opacity,
    void* stream) {
  if (sh_degree < 0 || sh_degree > 4 || rest_stride < rest_floats(sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const BwdArgs a{static_cast<const float*>(xyz),
                  static_cast<const float*>(fdc),
                  static_cast<const float*>(frest),
                  static_cast<const float*>(scaling),
                  static_cast<const float*>(rotation),
                  static_cast<const float*>(opacity),
                  static_cast<const bool*>(valid),
                  static_cast<const float*>(world_view),
                  static_cast<const float*>(full_proj),
                  static_cast<const float*>(center),
                  n,
                  rest_stride,
                  static_cast<float>(width),
                  static_cast<float>(height),
                  focal_x,
                  focal_y,
                  lim_x,
                  lim_y,
                  static_cast<const float*>(g_xy),
                  static_cast<const float*>(g_depth),
                  static_cast<const float*>(g_conic),
                  static_cast<const float*>(g_color),
                  static_cast<const float*>(g_opacity),
                  xy_stride,
                  depth_stride,
                  conic_stride,
                  color_stride,
                  opacity_stride,
                  static_cast<float*>(d_xyz),
                  static_cast<float*>(d_fdc),
                  static_cast<float*>(d_frest),
                  static_cast<float*>(d_scaling),
                  static_cast<float*>(d_rotation),
                  static_cast<float*>(d_opacity)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  return static_cast<int>(by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    point_front_bwd_kernel<D><<<blocks, kThreads, smem_bytes<D>(), s>>>(a);
    return cudaGetLastError();
  }));
}

// Blocks of the backward at sh_degree that one SM holds at once, from the
// runtime's occupancy calculator; -1 for an unsupported degree or an error.
extern "C" int point_front_bwd_blocks_per_sm(int sh_degree) {
  int n = 0;
  const cudaError_t err = by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, point_front_bwd_kernel<D>, kThreads, smem_bytes<D>());
  });
  return err == cudaSuccess ? n : -1;
}
