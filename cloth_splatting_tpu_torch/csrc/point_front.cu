// The front end of the splatting render in one pass: for every Gaussian of
// a field, its position and rotation, SH colour, 3D covariance and EWA
// projection from one camera. Two anchoring policies share the pass (the
// template parameter Anchor of front_pass), each with its own entry:
//
//   FreeXyz (point_front_kernel, point_front_launch): plain 3DGS, positions
//     and quaternions read as stored. Python wrapper ops/point_front.py
//     (project_points_fused); plain PyTorch version
//     models/point_gaussians.py::project_points_eager.
//   MeshAnchored (cloth_front_kernel, cloth_front_launch): the cloth field,
//     each Gaussian barycentric on one face of a (deformed) triangle mesh,
//     its rotation the face's rigid rotation rest -> deformed composed with
//     its own static quaternion. Python wrapper ops/cloth_front.py
//     (project_cloth_fused); plain PyTorch version
//     render.py::project_view_eager after the simulator.
//
// Neither replaces a TPU kernel: the JAX package's front ends
// (cloth_splatting_tpu/render.py::project_view and
// models/point_gaussians.py::project_points_view) are XLA. Each entry
// answers its plain version bit for bit. The cloth pass runs on the
// serving path (CUDA tensors, no leaf needing a gradient); the point pass
// also runs in training, as the forward of ops/point_front.py's autograd
// function, whose backward (point_front_bwd.cu) recomputes what it needs
// with the same device functions (front.cuh).
//
// What it computes, per Gaussian g. FreeXyz reads xyz [C, 3] and the WXYZ
// rotation [C, 4]. MeshAnchored reads face_bary [C, 3], face_ids [C], the
// faces [F, 3], the vertices [V, 3] the means sit on and the rest vertices
// [V, 3]; its mean is face_bary / sum(face_bary) (a sum under 1e-8 in
// magnitude taken as 1e-8) over the face's three vertices; its rotation
// (when the face rotations are on) is rotmat_to_quat(F_def F_rest^T) x
// normalize(rotation), F the orthonormal frame (edge, in-plane
// perpendicular, normal) of the face's triangle in the deformed and rest
// vertices, else normalize(rotation); it writes both as means3d [C, 3] and
// rotations [C, 4], scales the activated scales by scaling_modifier and
// may add a screen offset [C, 2] x (W/2, H/2) to the projected means. Both
// then take features_dc [C, 1, 3], features_rest [C, K-1, 3], log-scales
// [C, 3], the opacity logit [C, 1] and alive [C]: the unit view direction
// from the camera centre (norm clamped at 1e-8), the colour
// max(sum_k basis_k * sh_k + 0.5, 0) at degree DEG (MeshAnchored may take
// its colours from elsewhere and skip this), exp of the scales, the
// opacity's sigmoid, the normalized quaternion's rotation R, the packed
// covariance R diag(s^2) R^T, and the EWA projection of
// ops/projection.py::project_gaussians (frustum clamp at 1.3 tan(fov/2),
// +0.3 low-pass, conic, 3-sigma radius, uncapped or capped at max_radius
// with the support cut scaled, near cull at z <= 0.2, on-screen and alive
// tests; radius 0 and depth +inf where not valid). Every float operation is
// the PyTorch path's, in its order and rounding: each product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, which the compiler never fuses
// into an FMA) except where PyTorch's own kernel fuses one
// (torch.linalg.cross: a_i b_j - a_k b_l as fma(a_i, b_j, -(a_k b_l))),
// divisions and square roots are IEEE, exp and rsqrt the libdevice
// functions PyTorch's kernels call, the reductions (torch.linalg.norm and
// sums over 3, sums over 4) in the order of PyTorch's reduction kernel, and
// every constant a Python float rounded to float32. Those orders were
// probed on the H100 with torch 2.11: a sum over 3 is (v0 + v2) + v1, over
// 4 (v0 + v2) + (v1 + v3), and the cross product's first product is the
// fused one (0 mismatches on 3.0M random rows each; every other order
// mismatched on 20-33% of them).
//
// What bounds it on the H100. FreeXyz: bytes. A Gaussian reads 59 floats
// and a byte and writes 12 floats and a byte (~0.86 GB at 3.0M Gaussians,
// 0.26 ms at 3.35 TB/s) against ~400 fp32 operations (~0.02 ms at
// 67 TFLOP/s). MeshAnchored on the cloth field's 64,516 Gaussians: latency;
// its ~28 MB (the point row, the face's indices and six vertices, means3d
// and rotations besides) is ~8 us at the memory rate, one wave of ~500
// blocks, and its vertex gathers hit L2 (16,384 vertices, 32,258 faces).
//
// What the design does about it: each warp owns 32 consecutive Gaussians.
// It copies their rows of each input into shared memory with coalesced
// 16-byte loads (scalar coalesced loads where a row is not contiguous or
// aligned), each row at an odd stride in floats so that lane l reading
// float j of its own row hits bank (l * stride + j) mod 32 without a
// conflict; each lane then computes its Gaussian from shared memory, and
// the three-float outputs go back through shared memory as coalesced
// stores. No block-wide barrier: blocks of 4 warps, 30,208 bytes of shared
// memory each at degree 3 (7 blocks an SM). MeshAnchored stages face_bary
// where FreeXyz stages xyz, gathers the face and its vertices per lane (no
// cache, no state: a face's two Gaussians compute its frames twice) and
// stores its rotations as one 16-byte store a lane.

#include <cstdint>
#include <cuda_runtime.h>

#include "front.cuh"

namespace {

using namespace front;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct FrontArgs {
  const float* pos;         // [n, 3]: xyz (FreeXyz) or face_bary (MeshAnchored)
  const float* fdc;
  const float* frest;
  const float* scaling;
  const float* rotation;
  const float* opacity;
  const bool* alive;
  const float* world_view;  // [4, 4] row-vector transform
  const float* full_proj;   // [4, 4]
  const float* center;      // [3]
  int64_t n;
  int rest_stride;          // floats of features_rest a Gaussian: (K-1) * 3
  float width, height, focal_x, focal_y, lim_x, lim_y, max_radius;
  int capped;
  float* xy;
  float* depth;
  float* conic;
  float* radius;
  float* color;             // null: no colour (MeshAnchored's override)
  float* opacity_out;
  bool* valid;
  float* power_cut;
};

// MeshAnchored's inputs and outputs beside the pass's own
struct ClothArgs {
  FrontArgs f;
  const int64_t* face_ids;  // [n]
  const int64_t* faces;     // [F, 3]
  const float* verts;       // [V, 3] where the means sit (deformed, or rest)
  const float* rest;        // [V, 3] rest vertices: the frames' reference
  const float* offset;      // [n, 2] screen offset, or null
  float scale_mod;          // scaling_modifier
  float half_w, half_h;     // the offset's pixel scale: width / 2, height / 2
  int rotate;               // compose the face rotations (else the static one)
  float* means;             // [n, 3]
  float* rotations;         // [n, 4]
};

// FreeXyz: positions and quaternions as stored
struct FreeXyz {
  // (x, y, z) of Gaussian g from its staged row
  __device__ __forceinline__ void place(const float* pos, const float*, int64_t,
                                        float& x, float& y, float& z,
                                        float*) const {
    x = pos[0];
    y = pos[1];
    z = pos[2];
  }
  // the quaternion the covariance normalizes, read where the pass needs it
  __device__ __forceinline__ void quaternion(const float* rot, float q[4]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = rot[k];
  }
  __device__ __forceinline__ bool colored(const FrontArgs&) const { return true; }
  __device__ __forceinline__ float scaled(float s) const { return s; }
  __device__ __forceinline__ void shift(int64_t, float&, float&) const {}
  __device__ __forceinline__ float* means() const { return nullptr; }
};

// torch.linalg.cross's component a_i b_j - a_k b_l as PyTorch's kernel
// computes it on the card: the first product fused into an FMA, the second
// rounded on its own
__device__ __forceinline__ float cross_term(float ai, float bj, float ak,
                                            float bl) {
  return __fmaf_rn(ai, bj, -mul(ak, bl));
}

// (v * v).sum(-1) of a 3-vector, as PyTorch's reduction over 3 sums it
__device__ __forceinline__ float sum_sq3(const float v[3]) {
  return add(add(mul(v[0], v[0]), mul(v[2], v[2])), mul(v[1], v[1]));
}

// models/gaussians.py::_triangle_frames of the triangle (p[0], p[1], p[2]):
// f[i][c] is row i of column c, the columns (edge, in-plane perpendicular,
// normal); rsqrt(ss + 1e-12) keeps a degenerate triangle's frame finite
__device__ __forceinline__ void triangle_frame(const float p[3][3],
                                               float f[3][3]) {
  float e1[3], e2[3], n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = sub(p[1][k], p[0][k]);
    e2[k] = sub(p[2][k], p[0][k]);
  }
  n[0] = cross_term(e1[1], e2[2], e1[2], e2[1]);
  n[1] = cross_term(e1[2], e2[0], e1[0], e2[2]);
  n[2] = cross_term(e1[0], e2[1], e1[1], e2[0]);
  const float re = rsqrtf(add(sum_sq3(e1), F(1e-12)));
  const float rn = rsqrtf(add(sum_sq3(n), F(1e-12)));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = mul(e1[k], re);
    n[k] = mul(n[k], rn);
  }
  f[0][1] = cross_term(n[1], e1[2], n[2], e1[1]);
  f[1][1] = cross_term(n[2], e1[0], n[0], e1[2]);
  f[2][1] = cross_term(n[0], e1[1], n[1], e1[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i][0] = e1[i];
    f[i][2] = n[i];
  }
}

// ops/quaternion.py::rotmat_to_quat: the construction its rule selects
// (trace > 0, else the largest diagonal entry, ties to the earlier), then
// normalized. The rule picks among four constructions PyTorch computes
// all of; each is elementwise, so computing the selected one alone gives
// its bits.
__device__ __forceinline__ void rotmat_to_quat(const float m[3][3], float q[4]) {
  auto safe_sqrt = [](float v) { return __fsqrt_rn(clamp_lo(v, F(1e-8))); };
  const float tr = add(add(m[0][0], m[1][1]), m[2][2]);
  if (tr > 0.0f) {
    const float s = safe_sqrt(add(tr, 1.0f));
    const float d = mul(s, 2.0f);
    q[0] = mul(s, 0.5f);
    q[1] = div(sub(m[2][1], m[1][2]), d);
    q[2] = div(sub(m[0][2], m[2][0]), d);
    q[3] = div(sub(m[1][0], m[0][1]), d);
  } else if (m[0][0] >= m[1][1] && m[0][0] >= m[2][2]) {
    const float s = safe_sqrt(sub(sub(add(m[0][0], 1.0f), m[1][1]), m[2][2]));
    const float d = mul(s, 2.0f);
    q[0] = div(sub(m[2][1], m[1][2]), d);
    q[1] = mul(s, 0.5f);
    q[2] = div(add(m[0][1], m[1][0]), d);
    q[3] = div(add(m[0][2], m[2][0]), d);
  } else if (m[1][1] >= m[2][2]) {
    const float s = safe_sqrt(sub(add(sub(1.0f, m[0][0]), m[1][1]), m[2][2]));
    const float d = mul(s, 2.0f);
    q[0] = div(sub(m[0][2], m[2][0]), d);
    q[1] = div(add(m[0][1], m[1][0]), d);
    q[2] = mul(s, 0.5f);
    q[3] = div(add(m[1][2], m[2][1]), d);
  } else {
    const float s = safe_sqrt(add(sub(sub(1.0f, m[0][0]), m[1][1]), m[2][2]));
    const float d = mul(s, 2.0f);
    q[0] = div(sub(m[1][0], m[0][1]), d);
    q[1] = div(add(m[0][2], m[2][0]), d);
    q[2] = div(add(m[1][2], m[2][1]), d);
    q[3] = mul(s, 0.5f);
  }
  quat_normalize(q);
}

// ops/quaternion.py::quat_multiply: the Hamilton product a b
__device__ __forceinline__ void quat_multiply(const float a[4], const float b[4],
                                              float o[4]) {
  o[0] = sub(sub(sub(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2])),
             mul(a[3], b[3]));
  o[1] = sub(add(add(mul(a[0], b[1]), mul(a[1], b[0])), mul(a[2], b[3])),
             mul(a[3], b[2]));
  o[2] = add(add(sub(mul(a[0], b[2]), mul(a[1], b[3])), mul(a[2], b[0])),
             mul(a[3], b[1]));
  o[3] = add(sub(add(mul(a[0], b[3]), mul(a[1], b[2])), mul(a[2], b[1])),
             mul(a[3], b[0]));
}

__device__ __forceinline__ int64_t load_index(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// MeshAnchored: models/gaussians.py's gaussian_positions and
// gaussian_rotations, and the rest of render.py::project_view's prologue
struct MeshAnchored {
  const ClothArgs& c;

  // a vertex's three coordinates
  __device__ __forceinline__ void vertex(const float* v, int64_t i,
                                         float p[3]) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = __ldg(v + 3 * i + k);
  }

  // The mean and rotation of Gaussian g from its staged face_bary and
  // static quaternion; stores the rotation (rotations[g]), which the pass
  // then normalizes again, as build_covariance does
  __device__ __forceinline__ void place(const float* bary, const float* rot,
                                        int64_t g, float& x, float& y, float& z,
                                        float q[4]) const {
    const int64_t* face = c.faces + 3 * load_index(c.face_ids + g);
    int64_t vid[3];
    float d[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vid[i] = load_index(face + i);
      vertex(c.verts, vid[i], d[i]);
    }
    // face_bary / its sum (PyTorch's reduction over 3: (b0 + b2) + b1)
    const float bsum = add(add(bary[0], bary[2]), bary[1]);
    const float den = fabsf(bsum) < F(1e-8) ? F(1e-8) : bsum;
    float nb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) nb[i] = div(bary[i], den);
    auto coord = [&](int k) {
      return add(add(mul(nb[0], d[0][k]), mul(nb[1], d[1][k])), mul(nb[2], d[2][k]));
    };
    x = coord(0);
    y = coord(1);
    z = coord(2);

#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = rot[k];
    quat_normalize(q);
    if (c.rotate) {
      // R = F_def F_rest^T (bmm33_nt), its quaternion, then composed
      float r[3][3], fd[3][3], fr[3][3], m[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) vertex(c.rest, vid[i], r[i]);
      triangle_frame(d, fd);
      triangle_frame(r, fr);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          m[i][j] = add(add(mul(fd[i][0], fr[j][0]), mul(fd[i][1], fr[j][1])),
                        mul(fd[i][2], fr[j][2]));
      float qf[4], qs[4];
      rotmat_to_quat(m, qf);
#pragma unroll
      for (int k = 0; k < 4; ++k) qs[k] = q[k];
      quat_multiply(qf, qs, q);
    }
    reinterpret_cast<float4*>(c.rotations)[g] = make_float4(q[0], q[1], q[2], q[3]);
  }
  // the quaternion was placed with the mean
  __device__ __forceinline__ void quaternion(const float*, float*) const {}
  __device__ __forceinline__ bool colored(const FrontArgs& a) const {
    return a.color != nullptr;
  }
  // the activated scale times scaling_modifier
  __device__ __forceinline__ float scaled(float s) const {
    return mul(s, c.scale_mod);
  }
  // xy + screen_offset * (W/2, H/2)
  __device__ __forceinline__ void shift(int64_t g, float& px, float& py) const {
    if (c.offset != nullptr) {
      px = add(px, mul(__ldg(c.offset + 2 * g), c.half_w));
      py = add(py, mul(__ldg(c.offset + 2 * g + 1), c.half_h));
    }
  }
  __device__ __forceinline__ float* means() const { return c.means; }
};

// One pass over the Gaussians [0, a.n): a warp a 32 of them. Anchor places
// each (its position, and its quaternion with it or where the covariance
// needs it), says whether the colour is computed, scales the activated
// scales, shifts the projected mean, and names a means output to store
// through shared memory (or null).
template <int DEG, class Anchor>
__device__ __forceinline__ void front_pass(const FrontArgs& a, const Anchor& an) {
  constexpr int kCoef = (DEG + 1) * (DEG + 1);
  constexpr int kRest = rest_floats(DEG);
  constexpr int kRestSS = kRest ? odd_stride(kRest) : 0;
  // a warp's shared memory: rest rows, then positions, dc and log-scales (3
  // floats a row), then the quaternions (4 at a stride of 5)
  constexpr int kWarpFloats = 32 * kRestSS + 3 * 96 + 32 * 5;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_rest = reinterpret_cast<float*>(smem4) + warp * kWarpFloats;
  float* s_pos = s_rest + 32 * kRestSS;
  float* s_dc = s_pos + 96;
  float* s_sc = s_dc + 96;
  float* s_rot = s_sc + 96;

  const int64_t g0 = (int64_t(blockIdx.x) * kWarps + warp) * 32;
  if (g0 >= a.n) return;
  const int count = static_cast<int>(a.n - g0 < 32 ? a.n - g0 : 32);
  stage<3, 3>(s_pos, a.pos, g0, count, 3, lane);
  stage<3, 3>(s_dc, a.fdc, g0, count, 3, lane);
  if constexpr (kRest > 0)
    stage<kRest, kRestSS>(s_rest, a.frest, g0, count, a.rest_stride, lane);
  stage<3, 3>(s_sc, a.scaling, g0, count, 3, lane);
  stage<4, 5>(s_rot, a.rotation, g0, count, 4, lane);
  __syncwarp();

  const int64_t g = g0 + lane;
  const bool live = lane < count;
  float color[3] = {0.0f, 0.0f, 0.0f}, conic[3] = {0.0f, 0.0f, 0.0f};
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (live) {
    const float* wv = a.world_view;
    const float* fp = a.full_proj;
    float q[4];
    an.place(s_pos + lane * 3, s_rot + lane * 5, g, x, y, z, q);

    // view direction and SH colour
    const ViewDir vd = view_dir(x, y, z, a.center);
    if (an.colored(a)) {
      float b[kCoef];
      sh_basis<DEG>(vd.u[0], vd.u[1], vd.u[2], b);
      const float* rest = s_rest + lane * kRestSS;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        color[c] = clamp_lo(add(sh_sum<DEG>(b, s_dc + lane * 3, rest, c), 0.5f), 0.0f);
    }

    // activations: exp of the scales, the opacity's sigmoid
    float s2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = an.scaled(expf(s_sc[lane * 3 + k]));
      s2[k] = mul(s, s);
    }
    const float op = div(1.0f, add(1.0f, expf(-__ldcs(a.opacity + g))));

    // the covariance of the normalized quaternion's rotation
    an.quaternion(s_rot + lane * 5, q);
    quat_normalize(q);
    float r[3][3], cov[6];
    quat_rotmat(q, r);
    covariance(s2, r, cov);

    // project_gaussians
    const ScreenMean sm = screen_mean(x, y, z, wv, fp, a.width, a.height);
    const float tz = sm.tz, px = sm.px, py = sm.py;
    Ewa e;
    ewa(sm.t0, sm.t1, tz, cov, wv, a.focal_x, a.focal_y, a.lim_x, a.lim_y, e);
#pragma unroll
    for (int k = 0; k < 3; ++k) conic[k] = e.conic[k];
    const float c00 = e.c00, c11 = e.c11, det = e.det;
    const float mid = mul(add(c00, c11), 0.5f);
    const float lambda1 =
        add(mid, __fsqrt_rn(clamp_lo(sub(mul(mid, mid), det), F(0.1))));
    const float radius_raw = ceilf(mul(__fsqrt_rn(lambda1), 3.0f));
    float radius = radius_raw, power_cut = -4.5f;
    if (a.capped) {
      radius = clamp_hi(radius_raw, a.max_radius);
      const float ratio = div(radius, clamp_lo(radius_raw, 1.0f));
      power_cut = mul(mul(ratio, ratio), -4.5f);
    }
    const bool valid = tz > F(0.2) && det > 0.0f && add(px, radius) > 0.0f &&
                       sub(px, radius) < a.width && add(py, radius) > 0.0f &&
                       sub(py, radius) < a.height && a.alive[g];


    float ox = px, oy = py;
    an.shift(g, ox, oy);
    reinterpret_cast<float2*>(a.xy)[g] = make_float2(ox, oy);
    a.depth[g] = valid ? tz : INFINITY;
    a.radius[g] = valid ? radius : 0.0f;
    a.opacity_out[g] = op;
    a.valid[g] = valid;
    a.power_cut[g] = power_cut;
  }

  // colour, conic and the means back through shared memory (the inputs'
  // rows are read)
  float* const means = an.means();
  __syncwarp();
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_pos[lane * 3 + c] = color[c];
      s_dc[lane * 3 + c] = conic[c];
    }
    if (means != nullptr) {
      s_sc[lane * 3 + 0] = x;
      s_sc[lane * 3 + 1] = y;
      s_sc[lane * 3 + 2] = z;
    }
  }
  __syncwarp();
  const bool colored = an.colored(a);
  for (int e = lane; e < count * 3; e += 32) {
    if (colored) a.color[g0 * 3 + e] = s_pos[e];
    a.conic[g0 * 3 + e] = s_dc[e];
    if (means != nullptr) means[g0 * 3 + e] = s_sc[e];
  }
}

// (at least 6 blocks an SM: left to itself, ptxas gives the point pass at
// degree 3 40 registers and spills 16 bytes)
template <int DEG>
__global__ void __launch_bounds__(kThreads, 6) point_front_kernel(FrontArgs a) {
  front_pass<DEG>(a, FreeXyz{});
}

template <int DEG>
__global__ void __launch_bounds__(kThreads, 6) cloth_front_kernel(ClothArgs c) {
  front_pass<DEG>(c.f, MeshAnchored{c});
}

template <int DEG>
constexpr size_t smem_bytes() {
  constexpr int kRest = rest_floats(DEG);
  return sizeof(float) * kWarps *
         (32 * (kRest ? odd_stride(kRest) : 0) + 3 * 96 + 32 * 5);
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

FrontArgs front_args(const void* pos, const void* fdc, const void* frest,
                     int rest_stride, const void* scaling, const void* rotation,
                     const void* opacity, const void* alive,
                     const void* world_view, const void* full_proj,
                     const void* center, int64_t n, int width, int height,
                     float focal_x, float focal_y, float lim_x, float lim_y,
                     int capped, float max_radius, void* xy, void* depth,
                     void* conic, void* radius, void* color, void* opacity_out,
                     void* valid, void* power_cut) {
  return FrontArgs{static_cast<const float*>(pos),
                   static_cast<const float*>(fdc),
                   static_cast<const float*>(frest),
                   static_cast<const float*>(scaling),
                   static_cast<const float*>(rotation),
                   static_cast<const float*>(opacity),
                   static_cast<const bool*>(alive),
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
                   max_radius,
                   capped,
                   static_cast<float*>(xy),
                   static_cast<float*>(depth),
                   static_cast<float*>(conic),
                   static_cast<float*>(radius),
                   static_cast<float*>(color),
                   static_cast<float*>(opacity_out),
                   static_cast<bool*>(valid),
                   static_cast<float*>(power_cut)};
}

}  // namespace

// Launches the point front end on `stream` for n Gaussians at SH degree
// sh_degree (0-4). Inputs are device pointers to contiguous float32 xyz
// [n, 3], features_dc [n, 1, 3], features_rest [n, rest_stride / 3, 3]
// (rest_stride >= ((sh_degree + 1)^2 - 1) * 3), log-scales [n, 3], rotation
// [n, 4], opacity [n, 1], bool alive [n], the camera's world_view and
// full_proj [4, 4] and centre [3]; outputs contiguous xy [n, 2], depth,
// radius, opacity, power_cut [n], conic and color [n, 3] float32 and valid
// [n] bool. focal_* = size / (2 tan(fov/2)) and lim_* = 1.3 tan(fov/2),
// each a double rounded to float; capped != 0 caps radii at max_radius.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported degree).
extern "C" int point_front_launch(
    const void* xyz, const void* fdc, const void* frest, int rest_stride,
    const void* scaling, const void* rotation, const void* opacity,
    const void* alive, const void* world_view, const void* full_proj,
    const void* center, int64_t n, int sh_degree, int width, int height,
    float focal_x, float focal_y, float lim_x, float lim_y, int capped,
    float max_radius, void* xy, void* depth, void* conic, void* radius,
    void* color, void* opacity_out, void* valid, void* power_cut,
    void* stream) {
  if (sh_degree < 0 || sh_degree > 4 || rest_stride < rest_floats(sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const FrontArgs a = front_args(
      xyz, fdc, frest, rest_stride, scaling, rotation, opacity, alive,
      world_view, full_proj, center, n, width, height, focal_x, focal_y, lim_x,
      lim_y, capped, max_radius, xy, depth, conic, radius, color, opacity_out,
      valid, power_cut);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    point_front_kernel<D><<<blocks_for(n), kThreads, smem_bytes<D>(), s>>>(a);
    return cudaGetLastError();
  }));
}

// Launches the cloth front end on `stream` for the n mesh-anchored
// Gaussians at SH degree sh_degree (0-4): the point front end's inputs and
// outputs (FrontArgs) with face_bary [n, 3] in place of xyz, the static
// quaternions as rotation, radii capped at max_radius, and color null when
// the caller brings its own colours; besides, int64 face_ids [n] and faces
// [F, 3], float32 vertices [V, 3] the means sit on and rest vertices
// [V, 3] (rotate != 0 composes each face's rotation rest -> deformed with
// the static quaternion, else the static one alone), scale_mod (the
// scaling_modifier), an optional screen offset [n, 2] (null: none) scaled
// by (width / 2, height / 2), and the outputs means [n, 3] and rotations
// [n, 4]. Every face id must index faces and every face's vertices verts
// and rest. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported degree).
extern "C" int cloth_front_launch(
    const void* face_bary, const void* face_ids, const void* faces,
    const void* verts, const void* rest, int rotate, const void* fdc,
    const void* frest, int rest_stride, const void* scaling, float scale_mod,
    const void* rotation, const void* opacity, const void* alive,
    const void* world_view, const void* full_proj, const void* center,
    const void* offset, int64_t n, int sh_degree, int width, int height,
    float focal_x, float focal_y, float lim_x, float lim_y, float max_radius,
    void* xy, void* depth, void* conic, void* radius, void* color,
    void* opacity_out, void* valid, void* power_cut, void* means,
    void* rotations, void* stream) {
  if (sh_degree < 0 || sh_degree > 4 || rest_stride < rest_floats(sh_degree))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const ClothArgs c{
      front_args(face_bary, fdc, frest, rest_stride, scaling, rotation,
                 opacity, alive, world_view, full_proj, center, n, width,
                 height, focal_x, focal_y, lim_x, lim_y, 1, max_radius, xy,
                 depth, conic, radius, color, opacity_out, valid, power_cut),
      static_cast<const int64_t*>(face_ids),
      static_cast<const int64_t*>(faces),
      static_cast<const float*>(verts),
      static_cast<const float*>(rest),
      static_cast<const float*>(offset),
      scale_mod,
      static_cast<float>(width / 2.0),
      static_cast<float>(height / 2.0),
      rotate,
      static_cast<float*>(means),
      static_cast<float*>(rotations)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    cloth_front_kernel<D><<<blocks_for(n), kThreads, smem_bytes<D>(), s>>>(c);
    return cudaGetLastError();
  }));
}

// Blocks of the point (cloth) front end at sh_degree that one SM holds at
// once, from the runtime's occupancy calculator; -1 for an unsupported
// degree or an error.
extern "C" int point_front_blocks_per_sm(int sh_degree) {
  int n = 0;
  const cudaError_t err = by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, point_front_kernel<D>, kThreads, smem_bytes<D>());
  });
  return err == cudaSuccess ? n : -1;
}

extern "C" int cloth_front_blocks_per_sm(int sh_degree) {
  int n = 0;
  const cudaError_t err = by_degree(sh_degree, [&](auto deg) {
    constexpr int D = decltype(deg)::value;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, cloth_front_kernel<D>, kThreads, smem_bytes<D>());
  });
  return err == cudaSuccess ? n : -1;
}
