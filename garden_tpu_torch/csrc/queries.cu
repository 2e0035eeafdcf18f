// The swept-sphere cast for Hopper (sm_90a): one thread a (cast, body)
// pair, each pair computing only its own body's shape class.
//
// It replaces no TPU Pallas kernel: the JAX package casts with jnp ops
// (garden_tpu/physics/queries.py), and the port's plain version is
// garden_tpu_torch/physics/queries.py: cast_sphere_plain. That version
// computes every shape class's branch for every pair and then selects one
// (a 32-sample heightfield march and a 32-step mesh march among them), so
// one batched cast is ~8,800 launches whatever the scene holds.
// cast_sphere_launch computes the same hit in one launch.
//
// What it computes. For cast e (origin, direction, radius r, max distance,
// excluded body) and body j: the time of impact of the sphere's centre on
// the body's shape inflated by r: the sphere, the box slab and the capsule
// with r added, the plane moved by +r (as the plain version does), the
// hull's face planes pushed out by r, the heightfield marched by the
// centre against the surface lowered by r, a compound's children, a mesh's
// triangles offset by r along their normals; NO_HIT where the body is
// absent, excluded or farther than the max distance. The nearest pair of
// each cast wins (its lowest body index on a tie, as torch.argmin picks),
// and the last block of the cast writes its hit: the hit flag, the body
// (-1 without a hit), the distance, the contact normal from the closest
// point on the uninflated shape (the plane's, the heightfield's up and the
// hull face's for those classes) and the contact point.
//
// Rounding. Built with -fmad=false, each step is the plain version's
// float32 operation in its order, by the rules of torch_float.cuh; besides
// those: torch.linalg.cross rounds a component as fma(a, b, -(c * d)), as
// PyTorch's CUDA kernel is built with contraction on; einsum's
// contractions over three terms go to cuBLAS, whose batched gemm rounds
// them as fma(x1, y1, x0 * y0) + x2 * y2 at most shapes (gemm3) and the
// hull's vertex and face products as a chain of fmas (gemm3_chain). cuBLAS
// picks its kernel by the batch size, and some (a batch of ~16,000, or the
// part of a batch past 65,535) round as fma(x2, y2, x0 * y0) + x1 * y1
// instead: a box, hull, heightfield or mesh pair in such a batch can then
// differ by an ulp in its local coordinates, and its time of impact by a
// few ulps. The sphere, plane and capsule pairs are exact.
//
// Order of the hits. A pair's key is its time's bits, mapped so that they
// order as the floats do (+0 and -0 as one), above its body index; the
// smallest key is torch.argmin's pick. No NaN reaches a key: the mask
// `t <= max_distance` is false for a NaN time, which becomes NO_HIT, as in
// the plain version.
//
// What bounds it on the H100. A pair reads its body's row (pos, quat, shape
// index, has: 33 bytes) and its shape's type and parameters (20 bytes);
// every cast reads the same rows, so a call needs each from memory once
// and the other casts find it in cache. A box pair is 111 float
// operations (chip_smoke.py: CAST_OPS_BOX), the sphere, plane and capsule
// pairs ~100-250. At the engine frame's 8 casts x 10,248 bodies a call
// needs 0.34 MB of body rows, ~0.10 us at 3.35 TB/s, and 9.1 M operations
// on its box pairs, ~0.14 us at 67 TFLOP/s; the launch costs more than
// either.
//
// What the design does about it. Every pair branches on its body's type,
// so a scene pays a march only on its heightfield and mesh pairs, and a
// warp diverges only where types mix. Each block reduces its keys in
// registers and shared memory and takes one 64-bit atomicMax on the
// complement of its minimum into a zeroed workspace; the block that
// finishes a cast last (a counter beside the key) writes the hit.

#include <cuda_runtime.h>

#include "torch_float.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNoHit = F32(1e30);   // queries.NO_HIT
constexpr float kTiny = F32(1e-9);    // the guards against division by ~0
constexpr int kMarchSteps = 32;       // _ray_heightfield's and _ray_mesh's steps

// physics/shapes.py's type codes
constexpr int kSphere = 1, kBox = 2, kCapsule = 3, kHull = 4, kCompound = 5, kPlane = 6,
              kHeightfield = 7, kMesh = 8;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return dot3(a.x, a.y, a.z, b.x, b.y, b.z); }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum / amin / amax: NaN wins
__device__ __forceinline__ float tmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}

// torch.linalg.cross on the card: each component a * b - c * d with the
// first product fused
__device__ __forceinline__ float cross_c(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_c(a.y, b.z, a.z, b.y), cross_c(a.z, b.x, a.x, b.z),
          cross_c(a.x, b.y, a.y, b.x)};
}

// einsum's contraction over three terms (cuBLAS's batched gemm)
__device__ __forceinline__ float gemm3(float x0, float y0, float x1, float y1, float x2,
                                       float y2) {
  return __fmaf_rn(x1, y1, x0 * y0) + x2 * y2;
}
// the hull's vertex and face products: a chain of fmas
__device__ __forceinline__ float gemm3_chain(float x0, float y0, float x1, float y1,
                                             float x2, float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x1, y1, x0 * y0));
}

struct M3 {
  float m[3][3];
};

// m3.quat_to_mat3
__device__ __forceinline__ M3 quat_to_mat3(const float* q) {
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  M3 r;
  r.m[0][0] = 1.0f - 2.0f * (yy + zz);
  r.m[0][1] = 2.0f * (xy - wz);
  r.m[0][2] = 2.0f * (xz + wy);
  r.m[1][0] = 2.0f * (xy + wz);
  r.m[1][1] = 1.0f - 2.0f * (xx + zz);
  r.m[1][2] = 2.0f * (yz - wx);
  r.m[2][0] = 2.0f * (xz - wy);
  r.m[2][1] = 2.0f * (yz + wx);
  r.m[2][2] = 1.0f - 2.0f * (xx + yy);
  return r;
}

// einsum("...ji,...j->...i", rot, v): v in the rotation's frame
__device__ __forceinline__ V3 rot_t(const M3& r, V3 v) {
  return {gemm3(r.m[0][0], v.x, r.m[1][0], v.y, r.m[2][0], v.z),
          gemm3(r.m[0][1], v.x, r.m[1][1], v.y, r.m[2][1], v.z),
          gemm3(r.m[0][2], v.x, r.m[1][2], v.y, r.m[2][2], v.z)};
}

// einsum("...ij,...j->...i", rot, v)
__device__ __forceinline__ V3 rot_n(const M3& r, V3 v) {
  return {gemm3(r.m[0][0], v.x, r.m[0][1], v.y, r.m[0][2], v.z),
          gemm3(r.m[1][0], v.x, r.m[1][1], v.y, r.m[1][2], v.z),
          gemm3(r.m[2][0], v.x, r.m[2][1], v.y, r.m[2][2], v.z)};
}

// einsum("...ij,...kj->...ki", rot, rows): the hull's rows rotated
__device__ __forceinline__ V3 rot_chain(const M3& r, V3 v) {
  return {gemm3_chain(r.m[0][0], v.x, r.m[0][1], v.y, r.m[0][2], v.z),
          gemm3_chain(r.m[1][0], v.x, r.m[1][1], v.y, r.m[1][2], v.z),
          gemm3_chain(r.m[2][0], v.x, r.m[2][1], v.y, r.m[2][2], v.z)};
}

// m3.quat_rotate: v + w * t + cross(u, t), t = 2 * cross(u, v)
__device__ __forceinline__ V3 quat_rotate(const float* q, V3 v) {
  const V3 u{q[0], q[1], q[2]};
  const V3 t = scale(cross(u, v), 2.0f);
  return add(add(v, scale(t, q[3])), cross(u, t));
}

// m3.quat_mul(a, b)
__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* out) {
  const float ax = a[0], ay = a[1], az = a[2], aw = a[3];
  const float bx = b[0], by = b[1], bz = b[2], bw = b[3];
  out[0] = aw * bx + ax * bw + ay * bz - az * by;
  out[1] = aw * by - ax * bz + ay * bw + az * bx;
  out[2] = aw * bz + ax * by - ay * bx + az * bw;
  out[3] = aw * bw - ax * bx - ay * by - az * bz;
}

// m3.normalize
__device__ __forceinline__ V3 normalized(V3 v) {
  normalize(v.x, v.y, v.z);
  return v;
}

// Python's x % n of a float parameter read as a table row (x.long() % n)
__device__ __forceinline__ int table_row(float x, int n) {
  const long long r = static_cast<long long>(x) % n;
  return static_cast<int>(r < 0 ? r + n : r);
}

// narrowphase._row_index: a float parameter clamped into the table
__device__ __forceinline__ int clamped_row(float x, int n) {
  const long long r = static_cast<long long>(x);
  return static_cast<int>(r < 0 ? 0 : (r > n - 1 ? n - 1 : r));
}

// queries._safe_div_den
__device__ __forceinline__ float safe_den(float x) {
  return fabsf(x) < kTiny ? (x < 0.0f ? -kTiny : kTiny) : x;
}

// The bodies and the shape tables of a physics state, with their sizes.
struct World {
  const float* pos;      // (n, 3)
  const float* quat;     // (n, 4)
  const int* shape;      // (n,)
  const bool* has;       // (n,)
  int n;
  const int* type;       // (n_shapes,)
  const float* params;   // (n_shapes, 4)
  int n_shapes;
  const float* hull_verts;       // (n_hulls, hull_nv, 3)
  const bool* hull_vert_valid;   // (n_hulls, hull_nv)
  const float* hull_face_n;      // (n_hulls, hull_nf, 3)
  const bool* hull_face_valid;   // (n_hulls, hull_nf)
  int n_hulls, hull_nv, hull_nf;
  const float* hf_heights;       // (n_hf, hf_dim, hf_dim)
  int n_hf, hf_dim;
  const int* comp_type;          // (n_comp, comp_k)
  const float* comp_params;      // (n_comp, comp_k, 4)
  const float* comp_pos;         // (n_comp, comp_k, 3)
  const float* comp_quat;        // (n_comp, comp_k, 4)
  int n_comp, comp_k;
  const float* mesh_tris;        // (n_mesh, mesh_tris_n, 3, 3)
  const int* mesh_cells;         // (n_mesh, mesh_cells_n, mesh_bucket)
  const float* mesh_info;        // (n_mesh, 8)
  int n_mesh, mesh_tris_n, mesh_cells_n, mesh_bucket, mesh_g_dim;
};

// The casts: origin and direction (e, 3), radius, max distance and
// excluded body (e,); inflate 0 keeps the mesh's triangles where they are
// (a radius of Python's 0.0), as the plain version does.
struct Casts {
  const float* origin;
  const float* direction;
  const float* radius;
  const float* max_distance;
  const int* exclude;
  int inflate;
};

struct Out {
  unsigned long long* work;   // (2 e), zeroed: per cast the complement of the best key, a counter
  bool* hit;                  // (e,)
  long long* body;            // (e,)
  float* distance;            // (e,)
  float* point;               // (e, 3)
  float* normal;              // (e, 3)
};

// _ray_sphere
__device__ float ray_sphere(V3 o, V3 d, V3 center, float radius) {
  const V3 oc = sub(o, center);
  const float b = dot(oc, d);
  const float c = dot(oc, oc) - radius * radius;
  const float disc = b * b - c;
  const float t = -b - sqrtf(clamp_min(disc, 0.0f));
  return (disc >= 0.0f && t > 0.0f) ? t : kNoHit;
}

// _ray_box: the slab test in the box frame
__device__ float ray_box(V3 o, V3 d, V3 center, const M3& rot, V3 half) {
  const V3 ol = rot_t(rot, sub(o, center));
  const V3 dl = rot_t(rot, d);
  const float ols[3] = {ol.x, ol.y, ol.z}, dls[3] = {dl.x, dl.y, dl.z};
  const float hs[3] = {half.x, half.y, half.z};
  float t_in = 0.0f, t_out = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float inv = 1.0f / safe_den(dls[i]);
    const float t0 = (-hs[i] - ols[i]) * inv;
    const float t1 = (hs[i] - ols[i]) * inv;
    const float lo = tmin(t0, t1), hi = tmax(t0, t1);
    t_in = i == 0 ? lo : tmax(t_in, lo);
    t_out = i == 0 ? hi : tmin(t_out, hi);
  }
  const bool hit = t_out >= clamp_min(t_in, 0.0f);
  return (hit && t_in > 0.0f) ? t_in : kNoHit;
}

// _ray_plane
__device__ float ray_plane(V3 o, V3 d, V3 n, float dist) {
  const float denom = dot(d, n);
  const bool small = fabsf(denom) < kTiny;
  const float t = -(dot(o, n) + dist) / (small ? kTiny : denom);
  return (fabsf(denom) > kTiny && t > 0.0f) ? t : kNoHit;
}

// _ray_capsule
__device__ float ray_capsule(V3 o, V3 d, V3 p0, V3 p1, float radius) {
  const V3 axis = sub(p1, p0);
  const float ll = dot(axis, axis);
  const float len = sqrtf(clamp_min(ll, F32(1e-12)));
  const V3 u{axis.x / len, axis.y / len, axis.z / len};
  const V3 oc = sub(o, p0);
  const V3 d_perp = sub(d, scale(u, dot(d, u)));
  const V3 oc_perp = sub(oc, scale(u, dot(oc, u)));
  const float a = dot(d_perp, d_perp);
  const float b = dot(d_perp, oc_perp);
  const float c = dot(oc_perp, oc_perp) - radius * radius;
  const float disc = b * b - a * c;
  float t_cyl = (-b - sqrtf(clamp_min(disc, 0.0f))) / clamp_min(a, F32(1e-12));
  const float s = dot(add(oc, scale(d, t_cyl)), u);
  const float seg_len = sqrtf(clamp_min(ll, F32(1e-12)));
  const bool ok = disc >= 0.0f && a > F32(1e-12) && t_cyl > 0.0f && s >= 0.0f && s <= seg_len;
  t_cyl = ok ? t_cyl : kNoHit;
  return tmin(t_cyl, tmin(ray_sphere(o, d, p0, radius), ray_sphere(o, d, p1, radius)));
}

// _capsule_axes of one body or child: its ends along the rotated local Y
__device__ __forceinline__ void capsule_ends(V3 pos, const float* q, float half_height,
                                             V3& a0, V3& a1) {
  const V3 axis = quat_rotate(q, V3{0.0f, 1.0f, 0.0f});
  const V3 off = scale(axis, half_height);
  a0 = sub(pos, off);
  a1 = add(pos, off);
}

// _hull_support of face f: max over the valid vertices of dot(n_f, v)
__device__ float hull_support(const World& w, int h, const M3& rot, V3 pos, V3 face) {
  float best = 0.0f;
  for (int p = 0; p < w.hull_nv; ++p) {
    const int row = h * w.hull_nv + p;
    const V3 v = add(rot_chain(rot, load3(w.hull_verts + 3 * row)), pos);
    const float dp = w.hull_vert_valid[row]
                         ? gemm3_chain(face.x, v.x, face.y, v.y, face.z, v.z)
                         : -kNoHit;
    best = p == 0 ? dp : tmax(best, dp);
  }
  return best;
}

// _ray_hull: the slab test over the face planes pushed out by r
__device__ float ray_hull(const World& w, V3 o, V3 d, V3 pos, const float* q,
                          const float* prm, float r) {
  const int h = table_row(prm[0], w.n_hulls);
  const M3 rot = quat_to_mat3(q);
  float t_near = 0.0f, t_far = 0.0f;
  bool outside_parallel = false;
  for (int f = 0; f < w.hull_nf; ++f) {
    const int row = h * w.hull_nf + f;
    const V3 face = rot_chain(rot, load3(w.hull_face_n + 3 * row));
    const float d_f = hull_support(w, h, rot, pos, face) + r;
    const float no = gemm3(face.x, o.x, face.y, o.y, face.z, o.z);
    const float nd = gemm3(face.x, d.x, face.y, d.y, face.z, d.z);
    const float t_plane = (d_f - no) / safe_den(nd);
    const bool fv = w.hull_face_valid[row];
    const float near_f = (fv && nd < 0.0f) ? t_plane : -kNoHit;
    const float far_f = (fv && nd > 0.0f) ? t_plane : kNoHit;
    t_near = f == 0 ? near_f : tmax(t_near, near_f);
    t_far = f == 0 ? far_f : tmin(t_far, far_f);
    outside_parallel = outside_parallel || (fv && fabsf(nd) <= kTiny && no > d_f);
  }
  const bool hit = t_near <= t_far && t_near > 0.0f && !outside_parallel;
  return hit ? t_near : kNoHit;
}

// narrowphase._hf_plane_at, reduced to the march's test: is the local
// point p below the surface, and inside the grid?
__device__ bool hf_below(const World& w, V3 p, const float* prm) {
  const int h = clamped_row(prm[0], w.n_hf);
  const float cell = prm[1], nx = prm[2], nz = prm[3];
  const float gx = p.x / cell + (nx - 1.0f) * 0.5f;
  const float gz = p.z / cell + (nz - 1.0f) * 0.5f;
  const bool inside = gx >= 0.0f && gx <= nx - 1.0f && gz >= 0.0f && gz <= nz - 1.0f;
  const int ix = static_cast<int>(tmin(clamp_min(floorf(gx), 0.0f), nx - 2.0f));
  const int iz = static_cast<int>(tmin(clamp_min(floorf(gz), 0.0f), nz - 2.0f));
  const float fx = clamp(gx - static_cast<float>(ix), 0.0f, 1.0f);
  const float fz = clamp(gz - static_cast<float>(iz), 0.0f, 1.0f);
  const int dim = w.hf_dim;
  const int ixl = ix < 0 ? 0 : (ix > dim - 2 ? dim - 2 : ix);
  const int izl = iz < 0 ? 0 : (iz > dim - 2 ? dim - 2 : iz);
  const float* g = w.hf_heights + static_cast<long long>(h) * dim * dim;
  const float h00 = g[izl * dim + ixl], h10 = g[izl * dim + ixl + 1];
  const float h01 = g[(izl + 1) * dim + ixl], h11 = g[(izl + 1) * dim + ixl + 1];
  // two triangles per cell, split along fx + fz = 1
  const bool lower = fx + fz <= 1.0f;
  const V3 n_l = normalized(lower ? V3{-(h10 - h00), cell, -(h01 - h00)}
                                  : V3{-(h11 - h01), cell, -(h11 - h10)});
  const float x0 = (static_cast<float>(ix) - (nx - 1.0f) * 0.5f) * cell;
  const float z0 = (static_cast<float>(iz) - (nz - 1.0f) * 0.5f) * cell;
  const V3 p_on = lower ? V3{x0, h00, z0} : V3{x0 + cell, h11, z0 + cell};
  return dot(n_l, sub(p, p_on)) < 0.0f && inside;
}

// _ray_heightfield: the first of 32 samples below the surface, refined by
// one bisection; o is the sphere's centre lowered by r
__device__ float ray_heightfield(const World& w, V3 o, V3 d, V3 pos, const float* q,
                                 const float* prm, float max_distance) {
  const M3 rot = quat_to_mat3(q);
  const V3 o_l = rot_t(rot, sub(o, pos));
  const V3 d_l = rot_t(rot, d);
  const float span = prm[1] * tmax(prm[2], prm[3]);
  const float len = sqrtf(clamp_min(dot(o_l, o_l), 0.0f));
  const float t_reach = clamp_max(len + (0.5f * span + 1.0f) * F32(1.732), max_distance);
  // torch.linspace(0, 1, 32) on the card: its two halves from either end
  constexpr float kStep = 1.0f / static_cast<float>(kMarchSteps - 1);
  float prev_t = 0.0f;
  for (int i = 0; i < kMarchSteps; ++i) {
    const float u = i < kMarchSteps / 2
                        ? kStep * static_cast<float>(i)
                        : 1.0f - kStep * static_cast<float>(kMarchSteps - 1 - i);
    const float t = u * t_reach;
    if (hf_below(w, add(o_l, scale(d_l, t)), prm)) {
      const float mid = 0.5f * (prev_t + t);
      return hf_below(w, add(o_l, scale(d_l, mid)), prm) ? mid : t;
    }
    prev_t = t;
  }
  return kNoHit;
}

// _ray_compound: the nearest child, each inflated by r
__device__ float ray_compound(const World& w, V3 o, V3 d, V3 pos, const float* q,
                              const float* prm, float r) {
  const int c = table_row(prm[0], w.n_comp);
  float t_best = kNoHit;
  for (int k = 0; k < w.comp_k; ++k) {
    const int row = c * w.comp_k + k;
    const int tk = w.comp_type[row];
    const float* cp = w.comp_params + 4 * row;
    const V3 pk = add(quat_rotate(q, load3(w.comp_pos + 3 * row)), pos);
    float qk[4];
    quat_mul(q, w.comp_quat + 4 * row, qk);
    float tkid = kNoHit;
    if (tk == kSphere) {
      tkid = ray_sphere(o, d, pk, cp[0] + r);
    } else if (tk == kBox) {
      tkid = ray_box(o, d, pk, quat_to_mat3(qk), V3{cp[0] + r, cp[1] + r, cp[2] + r});
    } else if (tk == kCapsule) {
      V3 a0, a1;
      capsule_ends(pk, qk, cp[1], a0, a1);
      tkid = ray_capsule(o, d, a0, a1, cp[0] + r);
    }
    t_best = tmin(t_best, tkid);
  }
  return t_best;
}

// _ray_mesh: a 32-step march through the mesh's grid (the ray clipped to
// its box), each step testing its cell's bucket of triangles, offset by r
// along their normals where `inflate` is set
__device__ float ray_mesh(const World& w, V3 o, V3 d, V3 pos, const float* q,
                          const float* prm, float max_t, float r, bool inflate) {
  const M3 rot = quat_to_mat3(q);
  const V3 o_l = rot_t(rot, sub(o, pos));
  const V3 d_l = rot_t(rot, d);
  const int m = table_row(prm[0], w.n_mesh);
  const float* info = w.mesh_info + 8 * m;
  const float org[3] = {info[0], info[1], info[2]};
  const float cell = info[3];
  const int g = w.mesh_g_dim;
  const float span = cell * static_cast<float>(g);
  const float ols[3] = {o_l.x, o_l.y, o_l.z}, dls[3] = {d_l.x, d_l.y, d_l.z};
  float t_in = 0.0f, t_out = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float inv = 1.0f / safe_den(dls[i]);
    const float t0 = (org[i] - ols[i]) * inv;
    const float t1 = (org[i] + span - ols[i]) * inv;
    const float lo = tmin(t0, t1), hi = tmax(t0, t1);
    t_in = i == 0 ? lo : tmax(t_in, lo);
    t_out = i == 0 ? hi : tmin(t_out, hi);
  }
  const float tmin_c = clamp_min(t_in, 0.0f);
  const float tmax_c = clamp_max(t_out, max_t);
  if (tmax_c <= tmin_c) return kNoHit;
  const float step = (tmax_c - tmin_c) * (1.0f / static_cast<float>(kMarchSteps));
  float t_best = kNoHit;
  for (int i = 0; i < kMarchSteps; ++i) {
    const float t = tmin_c + F32(i + 0.5) * step;
    const V3 p = add(o_l, scale(d_l, t));
    const float ps[3] = {p.x, p.y, p.z};
    int ci[3];
    for (int k = 0; k < 3; ++k) {
      const int c = static_cast<int>((ps[k] - org[k]) / cell);
      ci[k] = c < 0 ? 0 : (c > g - 1 ? g - 1 : c);
    }
    int key = (ci[0] * g + ci[1]) * g + ci[2];
    key = key < w.mesh_cells_n ? key : w.mesh_cells_n - 1;
    const int* bucket = w.mesh_cells + (static_cast<long long>(m) * w.mesh_cells_n + key) *
                                           w.mesh_bucket;
    const float reach = t + step;
    for (int s = 0; s < w.mesh_bucket; ++s) {
      const int tri_id = bucket[s];
      const float* tri = w.mesh_tris + (static_cast<long long>(m) * w.mesh_tris_n +
                                        (tri_id < 0 ? 0 : tri_id)) * 9;
      V3 va = load3(tri), vb = load3(tri + 3), vc = load3(tri + 6);
      if (inflate) {
        const V3 off = scale(normalized(cross(sub(vb, va), sub(vc, va))), r);
        va = add(va, off);
        vb = add(vb, off);
        vc = add(vc, off);
      }
      const V3 e1 = sub(vb, va), e2 = sub(vc, va);
      const V3 pv = cross(d_l, e2);
      const float det = dot(e1, pv);
      const float inv_det = 1.0f / (fabsf(det) < kTiny ? kTiny : det);
      const V3 tv = sub(o_l, va);
      const float u = dot(tv, pv) * inv_det;
      const V3 qv = cross(tv, e1);
      const float v = dot(d_l, qv) * inv_det;
      const float t_tri = dot(e2, qv) * inv_det;
      const bool ok = tri_id >= 0 && fabsf(det) > kTiny && u >= F32(-1e-5) &&
                      v >= F32(-1e-5) && u + v <= F32(1.0 + 1e-5) && t_tri > 0.0f &&
                      t_tri <= reach;
      t_best = tmin(t_best, ok ? t_tri : kNoHit);
    }
  }
  return t_best;
}

__device__ __forceinline__ V3 cast_direction(const Casts& c, int e) {
  return normalized(load3(c.direction + 3 * e));
}

// the masked time of impact of cast e on body j
__device__ float pair_time(const World& w, const Casts& c, int e, int j) {
  if (!w.has[j] || j == c.exclude[e]) return kNoHit;
  const int s = w.shape[j];
  if (s < 0 || s >= w.n_shapes) return kNoHit;
  const int type = w.type[s];
  const float* prm = w.params + 4 * s;
  const float* q = w.quat + 4 * j;
  const V3 pos = load3(w.pos + 3 * j);
  const V3 o = load3(c.origin + 3 * e);
  const V3 d = cast_direction(c, e);
  const float r = c.radius[e];
  const float md = c.max_distance[e];
  float t = kNoHit;
  switch (type) {
    case kSphere:
      t = ray_sphere(o, d, pos, prm[0] + r);
      break;
    case kBox:
      t = ray_box(o, d, pos, quat_to_mat3(q), V3{prm[0] + r, prm[1] + r, prm[2] + r});
      break;
    case kPlane: {
      const V3 n_w = quat_rotate(q, load3(prm));
      t = ray_plane(o, d, n_w, (prm[3] - dot(n_w, pos)) + r);
      break;
    }
    case kCapsule: {
      V3 a0, a1;
      capsule_ends(pos, q, prm[1], a0, a1);
      t = ray_capsule(o, d, a0, a1, prm[0] + r);
      break;
    }
    case kHeightfield: {
      // the sphere's centre marched against the surface lowered by r
      const V3 low{o.x - 0.0f * r, o.y - 1.0f * r, o.z - 0.0f * r};
      t = ray_heightfield(w, low, d, pos, q, prm, md);
      break;
    }
    case kHull:
      t = ray_hull(w, o, d, pos, q, prm, r);
      break;
    case kCompound:
      t = ray_compound(w, o, d, pos, q, prm, r);
      break;
    case kMesh:
      t = ray_mesh(w, o, d, pos, q, prm, md, r, c.inflate != 0);
      break;
    default:
      break;
  }
  return t <= md ? t : kNoHit;
}

// the float's order as an unsigned int (+0 and -0 as one); no NaN arrives
__device__ __forceinline__ unsigned ordered(float t) {
  const unsigned u = t == 0.0f ? 0u : __float_as_uint(t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// queries._face_normal_at: the hull face whose plane p lies farthest
// outside of
__device__ V3 hull_face_normal(const World& w, V3 pos, const float* q, const float* prm,
                               V3 p) {
  const int h = table_row(prm[0], w.n_hulls);
  const M3 rot = quat_to_mat3(q);
  V3 best_face{0.0f, 0.0f, 0.0f};
  float best = 0.0f;
  for (int f = 0; f < w.hull_nf; ++f) {
    const int row = h * w.hull_nf + f;
    const V3 face = rot_chain(rot, load3(w.hull_face_n + 3 * row));
    float s = gemm3(face.x, p.x, face.y, p.y, face.z, p.z) -
              hull_support(w, h, rot, pos, face);
    s = w.hull_face_valid[row] ? s : -INFINITY;
    // torch.argmax: the first maximum, a NaN above all
    if (f == 0 || (!isnan(best) && (isnan(s) || s > best))) {
      best = s;
      best_face = face;
    }
  }
  return best_face;
}

// _closest_on_segment_single
__device__ V3 closest_on_segment(V3 a0, V3 a1, V3 p) {
  const V3 d = sub(a1, a0);
  const float t = dot(sub(p, a0), d) / clamp_min(dot(d, d), F32(1e-12));
  return add(a0, scale(d, clamp(t, 0.0f, 1.0f)));
}

// cast e's hit from its best key: the rest of cast_sphere_plain after its
// argmin
__device__ void write_hit(const World& w, const Casts& c, const Out& out, int e,
                          unsigned long long key) {
  const int j = static_cast<int>(key & 0xffffffffull);
  const float t = from_ordered(static_cast<unsigned>(key >> 32));
  const bool hit = t < kNoHit;
  const V3 d = cast_direction(c, e);
  const V3 center = add(load3(c.origin + 3 * e), scale(d, t));
  const float r = c.radius[e];
  const V3 pos = load3(w.pos + 3 * j);
  const float* q = w.quat + 4 * j;
  const int s = w.shape[j];
  const float* prm = w.params + 4 * s;
  const int type = w.type[s];
  V3 n;
  if (type == kPlane) {
    n = quat_rotate(q, load3(prm));
  } else if (type == kHeightfield) {
    n = V3{0.0f, 1.0f, 0.0f};
  } else if (type == kHull) {
    n = hull_face_normal(w, pos, q, prm, center);
  } else {
    // the normal from the closest point on the uninflated shape
    V3 support;
    if (type == kSphere) {
      support = pos;
    } else if (type == kBox) {
      const M3 rot = quat_to_mat3(q);
      const V3 l = rot_t(rot, sub(center, pos));
      const V3 cl{tmin(tmax(l.x, -prm[0]), prm[0]), tmin(tmax(l.y, -prm[1]), prm[1]),
                  tmin(tmax(l.z, -prm[2]), prm[2])};
      support = add(rot_n(rot, cl), pos);
    } else {
      V3 a0, a1;
      capsule_ends(pos, q, prm[1], a0, a1);
      support = closest_on_segment(a0, a1, center);
    }
    n = normalized(sub(center, support));
  }
  out.hit[e] = hit;
  out.body[e] = hit ? j : -1;
  out.distance[e] = t;
  const V3 p = sub(center, scale(n, r));
  out.point[3 * e] = p.x;
  out.point[3 * e + 1] = p.y;
  out.point[3 * e + 2] = p.z;
  out.normal[3 * e] = n.x;
  out.normal[3 * e + 1] = n.y;
  out.normal[3 * e + 2] = n.z;
}

// block b of the grid: cast b / blocks_per_cast, bodies kThreads x (b %
// blocks_per_cast) onward
__global__ void __launch_bounds__(kThreads)
    cast_sphere_kernel(const World w, const Casts c, const Out out, int blocks_per_cast) {
  const int e = blockIdx.x / blocks_per_cast;
  const int j = (blockIdx.x % blocks_per_cast) * kThreads + threadIdx.x;
  unsigned long long key = ~0ull;   // above every pair's key
  if (j < w.n) {
    key = (static_cast<unsigned long long>(ordered(pair_time(w, c, e, j))) << 32) |
          static_cast<unsigned>(j);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xffffffffu, key, off);
    key = other < key ? other : key;
  }
  __shared__ unsigned long long warp_best[kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_best[warp] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) key = warp_best[i] < key ? warp_best[i] : key;
    atomicMax(out.work + 2 * e, ~key);
    __threadfence();
    last = atomicAdd(out.work + 2 * e + 1, 1ull) == static_cast<unsigned long long>(
                                                         blocks_per_cast - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    write_hit(w, c, out, e, ~atomicAdd(out.work + 2 * e, 0ull));
  }
}

}  // namespace

// C entry point of the swept-sphere cast of e casts against n bodies: the
// physics state's body rows (pos, quat, shape, has) and shape tables with
// their sizes, as struct World names them; the casts as struct Casts names
// them; work (2 e) a zeroed workspace; hit (e, bool), body (e, int64),
// distance (e,), point and normal (e x 3) receive the hits. Bool and int64
// arrays pass as void pointers. Returns a cudaError_t code.
extern "C" int cast_sphere_launch(
    const float* pos, const float* quat, const int* shape, const void* has, int n,
    const int* type, const float* params, int n_shapes, const float* hull_verts,
    const void* hull_vert_valid, const float* hull_face_n, const void* hull_face_valid,
    int n_hulls, int hull_nv, int hull_nf, const float* hf_heights, int n_hf, int hf_dim,
    const int* comp_type, const float* comp_params, const float* comp_pos,
    const float* comp_quat, int n_comp, int comp_k, const float* mesh_tris,
    const int* mesh_cells, const float* mesh_info, int n_mesh, int mesh_tris_n,
    int mesh_cells_n, int mesh_bucket, int mesh_g_dim, const float* origin,
    const float* direction, const float* radius, const float* max_distance,
    const int* exclude, int inflate, int e, unsigned long long* work, void* hit, void* body,
    float* distance, float* point, float* normal, void* stream) {
  if (e <= 0) return (int)cudaSuccess;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const World w{pos,           quat,          shape,        static_cast<const bool*>(has),
                n,             type,          params,       n_shapes,
                hull_verts,    static_cast<const bool*>(hull_vert_valid),
                hull_face_n,   static_cast<const bool*>(hull_face_valid),
                n_hulls,       hull_nv,       hull_nf,      hf_heights,
                n_hf,          hf_dim,        comp_type,    comp_params,
                comp_pos,      comp_quat,     n_comp,       comp_k,
                mesh_tris,     mesh_cells,    mesh_info,    n_mesh,
                mesh_tris_n,   mesh_cells_n,  mesh_bucket,  mesh_g_dim};
  const Casts c{origin, direction, radius, max_distance, exclude, inflate};
  const Out out{work, static_cast<bool*>(hit), static_cast<long long*>(body), distance, point,
                normal};
  const int blocks_per_cast = (n + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(blocks_per_cast) * e;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cast_sphere_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(w, c, out, blocks_per_cast);
  return (int)cudaGetLastError();
}
