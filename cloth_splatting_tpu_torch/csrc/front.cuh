// Shared by the point and cloth front ends (point_front.cu) and the point
// front end's backward (point_front_bwd.cu): the float operations of the
// forward, each as PyTorch's kernels compute it on the card, the warp's
// staging of rows through shared memory, the SH basis, the quaternion's
// rotation, the covariance, the projected mean and the EWA projection. The
// backward recomputes its intermediates with these same functions, so every
// branch it takes (the colour clamp at 0, the txtz / tytz clamp, the tz and
// det guards) is the branch the forward took.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, which
// the compiler never fuses into an FMA), divisions and square roots are
// IEEE, exp and rsqrt the libdevice functions PyTorch's kernels call, the
// reductions in the order of PyTorch's reduction kernel on the card (a sum
// over 3 is (v0 + v2) + v1, over 4 (v0 + v2) + (v1 + v3)), and every
// constant a Python float rounded to float32.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace front {

// one rounding per operation, never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min / clamp_max / clamp on a CUDA float tensor: NaN passes
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The PyTorch path's constants: Python floats (doubles) rounded to float32
#define F(x) static_cast<float>(x)

// Shared-memory row stride of `used` floats: odd, so a warp reading one
// float of each of its 32 rows touches 32 banks
__host__ __device__ constexpr int odd_stride(int used) {
  return used % 2 ? used : used + 1;
}

// Rows of SH coefficients a degree uses beyond the DC term, times 3
__host__ __device__ constexpr int rest_floats(int deg) {
  return ((deg + 1) * (deg + 1) - 1) * 3;
}

// Copies the USED leading floats of the rows of Gaussians [g0, g0 + count)
// (rows `stride` floats apart from `src`) into dst, SS floats a row. The
// scalar loop alone covers every input, coalesced, but its integer division
// by USED per float costs: on the 3.0M-Gaussian gs-360-3m field at degree 3
// the forward takes 0.457 ms with it alone against 0.340 ms with the 16-byte
// path for whole, aligned warps (H100 80GB HBM3, CUDA events over 50).
// kStream reads with evict-first loads (rows read once); without it the
// loads stay in L1, for rows whose other floats another call reads next.
template <int USED, int SS, bool kStream = true>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int64_t g0, int count, int stride,
                                      int lane) {
  auto load = [](const float* p) { return kStream ? __ldcs(p) : __ldg(p); };
  const bool whole = count == 32 && stride == USED &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (whole) {
    // 32 rows of USED floats: 8 * USED float4s from a 16-byte boundary
    const float4* s4 = reinterpret_cast<const float4*>(src + g0 * USED);
    for (int v = lane; v < 8 * USED; v += 32) {
      const float4 q = kStream ? __ldcs(s4 + v) : __ldg(s4 + v);
      const int e = 4 * v;
      if constexpr (SS == USED) {
        *reinterpret_cast<float4*>(dst + e) = q;
      } else {
        const float vals[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[((e + k) / USED) * SS + (e + k) % USED] = vals[k];
      }
    }
  } else {
    for (int e = lane; e < count * USED; e += 32) {
      const int r = e / USED, c = e % USED;
      dst[r * SS + c] = load(src + (g0 + r) * stride + c);
    }
  }
}

// The real SH basis of ops/sh.py::sh_basis at the unit direction (x, y, z),
// each term in its Python expression's order, handed to emit(k, term) in
// the order k = 0, 1, ... T is float, or a type that carries a value's
// derivatives beside it (point_front_bwd.cu's Dual).
template <int DEG, class T, class Emit>
__device__ __forceinline__ void sh_terms(T x, T y, T z, Emit&& emit) {
  emit(0, T(F(0.28209479177387814)));
  if constexpr (DEG >= 1) {
    emit(1, mul(y, F(-0.4886025119029199)));
    emit(2, mul(z, F(0.4886025119029199)));
    emit(3, mul(x, F(-0.4886025119029199)));
  }
  if constexpr (DEG >= 2) {
    const T xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const T xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    emit(4, mul(xy, F(1.0925484305920792)));
    emit(5, mul(yz, F(-1.0925484305920792)));
    emit(6, mul(sub(sub(mul(zz, 2.0f), xx), yy), F(0.31539156525252005)));
    emit(7, mul(xz, F(-1.0925484305920792)));
    emit(8, mul(sub(xx, yy), F(0.5462742152960396)));
    if constexpr (DEG >= 3) {
      emit(9, mul(mul(y, F(-0.5900435899266435)), sub(mul(xx, 3.0f), yy)));
      emit(10, mul(mul(xy, F(2.890611442640554)), z));
      emit(11, mul(mul(y, F(-0.4570457994644658)),
                   sub(sub(mul(zz, 4.0f), xx), yy)));
      emit(12, mul(mul(z, F(0.3731763325901154)),
                   sub(sub(mul(zz, 2.0f), mul(xx, 3.0f)), mul(yy, 3.0f))));
      emit(13, mul(mul(x, F(-0.4570457994644658)),
                   sub(sub(mul(zz, 4.0f), xx), yy)));
      emit(14, mul(mul(z, F(1.445305721320277)), sub(xx, yy)));
      emit(15, mul(mul(x, F(-0.5900435899266435)), sub(xx, mul(yy, 3.0f))));
    }
    if constexpr (DEG >= 4) {
      emit(16, mul(mul(xy, F(2.5033429417967046)), sub(xx, yy)));
      emit(17, mul(mul(yz, F(-1.7701307697799304)), sub(mul(xx, 3.0f), yy)));
      emit(18, mul(mul(xy, F(0.9461746957575601)), sub(mul(zz, 7.0f), 1.0f)));
      emit(19, mul(mul(yz, F(-0.6690465435572892)), sub(mul(zz, 7.0f), 3.0f)));
      emit(20, mul(add(mul(zz, sub(mul(zz, 35.0f), 30.0f)), 3.0f),
                   F(0.10578554691520431)));
      emit(21, mul(mul(xz, F(-0.6690465435572892)), sub(mul(zz, 7.0f), 3.0f)));
      emit(22, mul(mul(sub(xx, yy), F(0.47308734787878004)),
                   sub(mul(zz, 7.0f), 1.0f)));
      emit(23, mul(mul(xz, F(-1.7701307697799304)), sub(xx, mul(yy, 3.0f))));
      emit(24, mul(sub(mul(xx, sub(xx, mul(yy, 3.0f))),
                       mul(yy, sub(mul(xx, 3.0f), yy))),
                   F(0.6258357354491761)));
    }
  }
}

// The basis as an array b[(DEG + 1)^2]
template <int DEG, class T>
__device__ __forceinline__ void sh_basis(T x, T y, T z, T* b) {
  sh_terms<DEG>(x, y, z, [&](int k, T v) { b[k] = v; });
}

// sum_k basis_k * sh_k of colour channel c, term by term in the JAX
// package's order: dc is the Gaussian's DC row (3 floats), rest its higher
// coefficients (rows of 3); the colour is max(this + 0.5, 0)
template <int DEG>
__device__ __forceinline__ float sh_sum(const float* b, const float* dc,
                                        const float* rest, int c) {
  float v = mul(b[0], dc[c]);
#pragma unroll
  for (int k = 1; k < (DEG + 1) * (DEG + 1); ++k)
    v = add(v, mul(b[k], rest[(k - 1) * 3 + c]));
  return v;
}

// quat_normalize: q * rsqrt(sum q^2 + 1e-12), the sum as PyTorch's
// reduction over 4 takes it: (w^2 + y^2) + (x^2 + z^2); returns the rsqrt
__device__ __forceinline__ float quat_normalize(float q[4]) {
  const float ss = add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                       add(mul(q[1], q[1]), mul(q[3], q[3])));
  const float inv = rsqrtf(add(ss, F(1e-12)));
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = mul(q[k], inv);
  return inv;
}

// quat_to_rotmat of a normalized WXYZ quaternion
__device__ __forceinline__ void quat_rotmat(const float q[4], float r[3][3]) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  r[0][0] = sub(1.0f, mul(add(mul(qy, qy), mul(qz, qz)), 2.0f));
  r[0][1] = mul(sub(mul(qx, qy), mul(qw, qz)), 2.0f);
  r[0][2] = mul(add(mul(qx, qz), mul(qw, qy)), 2.0f);
  r[1][0] = mul(add(mul(qx, qy), mul(qw, qz)), 2.0f);
  r[1][1] = sub(1.0f, mul(add(mul(qx, qx), mul(qz, qz)), 2.0f));
  r[1][2] = mul(sub(mul(qy, qz), mul(qw, qx)), 2.0f);
  r[2][0] = mul(sub(mul(qx, qz), mul(qw, qy)), 2.0f);
  r[2][1] = mul(add(mul(qy, qz), mul(qw, qx)), 2.0f);
  r[2][2] = sub(1.0f, mul(add(mul(qx, qx), mul(qy, qy)), 2.0f));
}

// sym33_from_rs: R diag(s2) R^T packed as (xx, xy, xz, yy, yz, zz)
__device__ __forceinline__ void covariance(const float s2[3], const float r[3][3],
                                           float cov[6]) {
  auto entry = [&](int i, int j) {
    return add(add(mul(mul(s2[0], r[i][0]), r[j][0]),
                   mul(mul(s2[1], r[i][1]), r[j][1])),
               mul(mul(s2[2], r[i][2]), r[j][2]));
  };
  cov[0] = entry(0, 0);
  cov[1] = entry(0, 1);
  cov[2] = entry(0, 2);
  cov[3] = entry(1, 1);
  cov[4] = entry(1, 2);
  cov[5] = entry(2, 2);
}

// The unit view direction from the camera centre: u = d / max(|d|, 1e-8),
// d = xyz - centre, the norm summed as PyTorch's reduction over 3 does:
// x^2 + z^2, then y^2
struct ViewDir {
  float d[3];
  float len;  // |d|
  float nrm;  // max(|d|, 1e-8)
  float u[3];
};

__device__ __forceinline__ ViewDir view_dir(float x, float y, float z,
                                            const float* center) {
  ViewDir v;
  v.d[0] = sub(x, __ldg(center + 0));
  v.d[1] = sub(y, __ldg(center + 1));
  v.d[2] = sub(z, __ldg(center + 2));
  v.len = __fsqrt_rn(add(add(mul(v.d[0], v.d[0]), mul(v.d[2], v.d[2])),
                         mul(v.d[1], v.d[1])));
  v.nrm = clamp_lo(v.len, F(1e-8));
#pragma unroll
  for (int k = 0; k < 3; ++k) v.u[k] = div(v.d[k], v.nrm);
  return v;
}

// Column j of affine4_shared's row-vector transform [x, y, z, 1] @ m
__device__ __forceinline__ float affine(float x, float y, float z,
                                        const float* m, int j) {
  return add(add(add(mul(x, __ldg(m + j)), mul(y, __ldg(m + 4 + j))),
                 mul(z, __ldg(m + 8 + j))),
             __ldg(m + 12 + j));
}

// project_gaussians' camera-space mean (t0, t1, tz) and pixel mean (px, py)
// from the homogeneous clip coordinates h0, h1 and p_w = 1 / (h3 + 1e-7)
struct ScreenMean {
  float t0, t1, tz, h0, h1, p_w, px, py;
};

__device__ __forceinline__ ScreenMean screen_mean(float x, float y, float z,
                                                  const float* wv,
                                                  const float* fp, float width,
                                                  float height) {
  ScreenMean s;
  s.t0 = affine(x, y, z, wv, 0);
  s.t1 = affine(x, y, z, wv, 1);
  s.tz = affine(x, y, z, wv, 2);
  s.p_w = div(1.0f, add(affine(x, y, z, fp, 3), F(1e-7)));
  s.h0 = affine(x, y, z, fp, 0);
  s.h1 = affine(x, y, z, fp, 1);
  s.px = sub(mul(mul(add(mul(s.h0, s.p_w), 1.0f), width), 0.5f), 0.5f);
  s.py = sub(mul(mul(add(mul(s.h1, s.p_w), 1.0f), height), 0.5f), 0.5f);
  return s;
}

// project_gaussians' EWA projection of the packed covariance cov from the
// camera-space mean: the frustum clamp of t / tz at +-lim, the Jacobian J,
// A = J W (W_colvec[i][j] = world_view[j][i]), the 2D covariance A cov A^T
// with the +0.3 low-pass (sym33_quadform2), its determinant and inverse
struct Ewa {
  float tz_safe, rx, ry, txtz, tytz, tx, ty, inv_z, inv_z2;
  float a0[3], a1[3];  // rows of A
  float t[3], u[3];    // cov a0, cov a1
  float c00, c01, c11, det, inv_det;
  float conic[3];
};

__device__ __forceinline__ void ewa(float t0, float t1, float tz,
                                    const float cov[6], const float* wv,
                                    float focal_x, float focal_y, float lim_x,
                                    float lim_y, Ewa& e) {
  e.tz_safe = fabsf(tz) < F(1e-6) ? F(1e-6) : tz;
  e.rx = div(t0, e.tz_safe);
  e.ry = div(t1, e.tz_safe);
  e.txtz = clamp(e.rx, -lim_x, lim_x);
  e.tytz = clamp(e.ry, -lim_y, lim_y);
  e.tx = mul(e.txtz, e.tz_safe);
  e.ty = mul(e.tytz, e.tz_safe);
  e.inv_z = div(1.0f, e.tz_safe);
  e.inv_z2 = mul(e.inv_z, e.inv_z);
  const float j00 = mul(e.inv_z, focal_x);
  const float j02 = mul(mul(e.tx, -focal_x), e.inv_z2);
  const float j11 = mul(e.inv_z, focal_y);
  const float j12 = mul(mul(e.ty, -focal_y), e.inv_z2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e.a0[k] = add(mul(j00, __ldg(wv + 4 * k)), mul(j02, __ldg(wv + 4 * k + 2)));
    e.a1[k] = add(mul(j11, __ldg(wv + 4 * k + 1)), mul(j12, __ldg(wv + 4 * k + 2)));
  }
  // sym33_quadform2
  auto s_dot = [&](const float q[3], float o[3]) {
    o[0] = add(add(mul(cov[0], q[0]), mul(cov[1], q[1])), mul(cov[2], q[2]));
    o[1] = add(add(mul(cov[1], q[0]), mul(cov[3], q[1])), mul(cov[4], q[2]));
    o[2] = add(add(mul(cov[2], q[0]), mul(cov[4], q[1])), mul(cov[5], q[2]));
  };
  s_dot(e.a0, e.t);
  e.c00 = add(add(mul(e.a0[0], e.t[0]), mul(e.a0[1], e.t[1])), mul(e.a0[2], e.t[2]));
  e.c01 = add(add(mul(e.a1[0], e.t[0]), mul(e.a1[1], e.t[1])), mul(e.a1[2], e.t[2]));
  s_dot(e.a1, e.u);
  e.c11 = add(add(mul(e.a1[0], e.u[0]), mul(e.a1[1], e.u[1])), mul(e.a1[2], e.u[2]));
  e.c00 = add(e.c00, F(0.3));
  e.c11 = add(e.c11, F(0.3));
  e.det = sub(mul(e.c00, e.c11), mul(e.c01, e.c01));
  const float det_safe = fabsf(e.det) < F(1e-12) ? F(1e-12) : e.det;
  e.inv_det = div(1.0f, det_safe);
  e.conic[0] = mul(e.c11, e.inv_det);
  e.conic[1] = mul(-e.c01, e.inv_det);
  e.conic[2] = mul(e.c00, e.inv_det);
}

// fn(std::integral_constant<int, d>{}) at SH degree d in [0, 4], else
// cudaErrorInvalidValue
template <class Fn>
cudaError_t by_degree(int sh_degree, Fn fn) {
  switch (sh_degree) {
    case 0: return fn(std::integral_constant<int, 0>{});
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace front
