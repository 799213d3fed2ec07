// Device code shared by the render kernels (megakernel_linear.cu and
// megakernel_tree.cu), their ring instances (ring_shade.cu) and the scan
// kernel (scan_hit.cu): the scene buffer's layout, the counter-based RNG,
// the primary ray, closest hit and the shadow any-hit query in their two
// forms (a loop over the object rows in shared memory for small scenes, a
// fold over the unified primitive table for large ones, which a warp runs
// one ray at a time with a table row per thread), light sampling, the
// skybox lookup, the shading of one node (its two queries answered by a
// policy: the scene, or the ring's buffers) and a step of the DFS.  One
// thread handles one lane.
//
// The arithmetic follows the plain PyTorch version operation by operation
// (raytrace_tpu_torch/render/integrator.py, models/materials.py,
// models/lights.py, models/cameras.py, ops/intersect.py); the RNG words are
// bit-identical (uint32 wraparound).  In the linear kernel floats may
// differ by the rounding of contracted multiply-adds; the comparison that
// decides whether light refracts (sin^2 < 1) is computed without
// contraction, so it rounds as the plain version does.  The tree kernel and
// the ring instances are compiled without contraction altogether
// (ops/_build.py, KERNEL_FLAGS) and give the plain version's floats to the
// bit on the card, whose sqrtf, rsqrtf, sinf, cosf and powf are the ones
// PyTorch's CUDA operators call.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace rt {

// ---- scene buffer layout; raytrace_tpu_torch/render/megakernel.py packs it
constexpr int HDR = 24;        // header floats
constexpr int H_CAM_POS = 0;   // 3
constexpr int H_CAM_M = 3;     // 9, row-major
constexpr int H_BG = 12;       // 3
constexpr int H_HALFW = 15;
constexpr int H_HALFH = 16;
constexpr int H_SCALE = 17;
constexpr int H_MIN_SIG = 18;
constexpr int H_FOCUS = 19;    // depth-of-field focal distance
constexpr int H_APERTURE = 20;
constexpr int H_IM_DIST = 21; // 22, 23: pad
// floats per light, after the header: 13 used and 3 of pad, so that every
// object row starts 16-byte aligned and its columns load as 128-bit LDS
constexpr int LROW = 16;
constexpr int L_TYPE = 0;      // 0 point, 1 directional, 2 area
constexpr int L_P = 1;         // 3
constexpr int L_E1 = 4;        // 3
constexpr int L_E2 = 7;        // 3
constexpr int L_COLOR = 10;    // 3; 13-15 pad
constexpr int ROW = 24;        // floats per object, after the lights
constexpr int R_P = 0;         // sphere center / plane point, 3
constexpr int R_Q = 3;         // sphere radius in [0] / plane normal, 3
constexpr int R_DIFF = 6;      // 3
constexpr int R_SPEC = 9;      // 3
constexpr int R_AMB = 12;      // 3
constexpr int R_EXP = 15;
constexpr int R_IOR = 16;
constexpr int R_MS = 17;       // MC samples as float
constexpr int R_FRE = 18;      // 1 = Fresnel
constexpr int R_TRA = 19;      // 1 = Transparent
constexpr int R_IND = 20;      // 1 = IndirectPhong
constexpr int R_SPH = 21;      // 1 = sphere, 0 = plane
// a small scene's rows only (0 in a large scene's; 23 is a pad): what the
// object test would recompute in every lane, with the plain version's
// rounding, a sphere's r * r and a plane's p.n (its three products summed
// left to right)
constexpr int R_PRE = 22;

constexpr int LIGHT_DIRECTIONAL = 1;
constexpr int LIGHT_AREA = 2;

constexpr int THREADS = 128;

// ---- RNG (ops/rng.py)
constexpr uint32_t GAMMA = 0x9E3779B9u;
constexpr uint32_t PURPOSE_AA_X = 0u;
constexpr uint32_t PURPOSE_AA_Y = 1u;
constexpr uint32_t PURPOSE_LENS_THETA = 2u;
constexpr uint32_t PURPOSE_LENS_R = 3u;
constexpr uint32_t PURPOSE_LIGHT_U = 64u;
constexpr uint32_t PURPOSE_LIGHT_V = 65u;
constexpr uint32_t PURPOSE_INDIRECT_R1 = 1u << 16;
constexpr uint32_t PURPOSE_INDIRECT_R2 = (1u << 16) + 1u;
constexpr float OFFSET = (float)1e-5;               // secondary-ray origin offset
constexpr float TWO_PI = (float)6.283185307179586;  // float(2 pi)
constexpr float INV_PI = (float)0.3183098861837907; // float(1 / pi)

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// ops/rng.py::hash_words with a seed word s, of (px, py, aa) into k3 and
// of (px, py, aa, cam) into k4: the common prefix is absorbed once
__device__ __forceinline__ void primary_keys(uint32_t s, uint32_t px, uint32_t py,
                                             uint32_t aa, uint32_t cam, uint32_t& k3,
                                             uint32_t& k4) {
  uint32_t h = s ^ 0x243F6A88u;
  h = mix32(h + px + GAMMA * 1u);
  h = mix32(h + py + GAMMA * 3u);
  h = mix32(h + aa + GAMMA * 5u);
  k3 = mix32(h);
  k4 = mix32(mix32(h + cam + GAMMA * 7u));
}

// ops/rng.py::draw, float32: 24 random bits scaled by 2**-24
__device__ __forceinline__ float draw(uint32_t k1, uint32_t k2, uint32_t purpose) {
  uint32_t bits = mix32(k1 ^ mix32(k2 + GAMMA * (purpose + 1u)));
  return (float)(int)(bits >> 8) * 5.9604644775390625e-8f;
}

// ops/rng.py::derive: the stream of child slot `slot`
__device__ __forceinline__ void derive(uint32_t& k1, uint32_t& k2, uint32_t slot) {
  const uint32_t s = slot + 1u;
  k1 = mix32(k1 + GAMMA * s);
  k2 = mix32(k2 ^ (0xBB67AE85u * s));
}

// ---- per-lane path state: one chain link, or one DFS stack entry
// (integrator.tree_loop_entry's 13 components)
struct Node {
  float ox, oy, oz, dx, dy, dz;  // ray
  float sig;                     // significance
  float tx, ty, tz;              // throughput
  uint32_t k1, k2;               // RNG stream
  bool live;
};

// ---- the unified primitive table of a large scene as the folds read it
// (raytrace_tpu_torch/ops/intersect_scan.py::fold_buffer, made from
// ops/intersect.py::_packed_tables): n_chunks chunks of CHUNK rows, the
// sphere chunks first.  One buffer of 32-bit words: the rows (4 floats
// each), then one object id per row, then one bounding sphere (4 floats)
// per chunk.  A block stages the buffer into shared memory when it fits
// (SH, below) and reads it from device memory through the read-only cache
// when it does not.
constexpr int CHUNK = 32;
constexpr int ID_SENTINEL = 0x7FFFFFFF;  // the id of a lane that hit nothing
constexpr int LARGE_THREADS = 256;       // threads per block of the large instances
struct Tables {
  const float4* tab;  // sphere row (cx, cy, cz, r*r; -inf for r*r on pad rows and on a
                      // radius that is not positive), plane row (nx, ny, nz, p.n; zeros on pad rows)
  const int* ids;     // object id of each row, -1 on pad rows
  const float4* bnd;  // one bounding sphere (cx, cy, cz, R) per chunk
  int n_sph_chunks, n_chunks;
};

__host__ __device__ __forceinline__ size_t fold_bytes(int n_chunks) {
  return sizeof(float) * (size_t)n_chunks * (CHUNK * 5 + 4);
}

// the three parts of a fold buffer that starts at `buf`, in either memory
__host__ __device__ __forceinline__ Tables make_tables(const void* buf, int n_sph_chunks,
                                                       int n_chunks) {
  const float4* tab = (const float4*)buf;
  const int* ids = (const int*)(tab + (size_t)n_chunks * CHUNK);
  return Tables{tab, ids, (const float4*)(ids + (size_t)n_chunks * CHUNK), n_sph_chunks,
                n_chunks};
}

// ---- skybox (models/backgrounds.py::_skybox).  Replaces the skybox regime
// of raytrace_tpu/render/megakernel.py::_kernel: there a miss leaves the
// kernel as a record (direction, throughput) and a post-pass outside it
// does the texture gather; here the lookup runs where the ray misses.
// What bounds it on an H100 is the memory system: a random direction
// needs two rows of a face, and the faces (six of 1024 x 1024 are 75.5 MB)
// exceed the 50 MB L2.  So the lookup reads a form of the cube packed for
// it (models/backgrounds.py::pack_sky, rebuilt when the cube changes): at
// each texel (face, y, x) of a face the 12 floats of its bilinear
// neighbourhood, texels (y, x), (y1, x), (y, x1) and (y1, x1) in RGB, with
// x1 = min(x + 1, w - 1) and y1 = min(y + 1, h - 1) clamped at the face's
// own size when packed, and 4 floats of pad.  A lookup is three 16-byte
// loads from one 64-byte aligned block: two 32-byte sectors, the least that
// two rows of a face can take, in one of the 64-byte blocks that device
// memory serves, where the cube's four 12-byte texels took 12 scalar loads
// and 3.25 sectors on average (a 48-byte run without the pad straddles two
// blocks half the time).  The packed form holds 5.33x the cube's bytes;
// the wrapper checks that its element count fits the 32-bit index
// arithmetic below.
struct Sky {
  const float4* quads;  // (6, hmax, wmax, 16) float32; null: a solid background
  int hmax, wmax;       // strides of the padded faces
  int h[6], w[6];       // each face's own size: px nx py ny pz nz
};

// Dominant axis by strict > tested in x, y, z order (a tie for the largest
// component is black), the face's UV, clamped bilinear fetch at the face's
// own size.  Division is IEEE and every product and sum is rounded on its
// own, in the plain version's order, so both take the same texels and
// weights; they part only where the plain version's direction differs.
__device__ __forceinline__ void sky_lookup(const Sky& sky, float dx, float dy, float dz,
                                           float& r, float& g, float& b) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  int face, fh, fw;
  float u, v;
  if (ax > az && ax > ay) {
    face = dx > 0.0f ? 0 : 1;
    fh = dx > 0.0f ? sky.h[0] : sky.h[1];
    fw = dx > 0.0f ? sky.w[0] : sky.w[1];
    u = -dz / dx;
    v = -dy / ax;
  } else if (ay > ax && ay > az) {
    face = dy > 0.0f ? 2 : 3;
    fh = dy > 0.0f ? sky.h[2] : sky.h[3];
    fw = dy > 0.0f ? sky.w[2] : sky.w[3];
    u = dx / ay;
    v = dz / dy;
  } else if (az > ax && az > ay) {
    face = dz > 0.0f ? 4 : 5;
    fh = dz > 0.0f ? sky.h[4] : sky.h[5];
    fw = dz > 0.0f ? sky.w[4] : sky.w[5];
    u = dx / dz;
    v = -dy / az;
  } else {
    r = g = b = 0.0f;
    return;
  }
  u = __fadd_rn(__fmul_rn(u, 0.5f), 0.5f);
  v = __fadd_rn(__fmul_rn(v, 0.5f), 0.5f);
  // Texture::sample: clamp, scale by size - 1, bilinear, y first
  const float x = __fmul_rn(fminf(fmaxf(u, 0.0f), 1.0f), (float)(fw - 1));
  const float y = __fmul_rn(fminf(fmaxf(v, 0.0f), 1.0f), (float)(fh - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  const float xx = x - x0, yy = y - y0;
  const float omx = 1.0f - xx, omy = 1.0f - yy;
  // q0 = c00.rgb c01.r, q1 = c01.gb c10.rg, q2 = c10.b c11.rgb
  const float4* q =
      sky.quads + 4u * (unsigned)((face * sky.hmax + (int)y0) * sky.wmax + (int)x0);
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
  const auto mix = [](float p, float wp, float q, float wq) {
    return __fadd_rn(__fmul_rn(p, wp), __fmul_rn(q, wq));
  };
  r = mix(mix(q0.x, omy, q0.w, yy), omx, mix(q1.z, omy, q2.y, yy), xx);
  g = mix(mix(q0.y, omy, q1.x, yy), omx, mix(q1.w, omy, q2.z, yy), xx);
  b = mix(mix(q0.z, omy, q1.y, yy), omx, mix(q2.x, omy, q2.w, yy), xx);
}

// the packed faces and their sizes as the wrappers pass them: `quads` in
// device memory, 16-byte aligned, and hmax, wmax, then (h, w) of the six
// faces, 14 ints in host memory; a null `quads` is a solid background
__host__ __forceinline__ Sky make_sky(const float* quads, const int* face_hw) {
  Sky sky{};
  sky.quads = (const float4*)quads;
  if (quads == nullptr) return sky;
  sky.hmax = face_hw[0];
  sky.wmax = face_hw[1];
  for (int f = 0; f < 6; ++f) {
    sky.h[f] = face_hw[2 + 2 * f];
    sky.w[f] = face_hw[3 + 2 * f];
  }
  return sky;
}

// the scene as the kernels see it, and the static slot layout: header and
// lights staged in shared memory (s); the object rows behind them there
// too for a small scene, or in device memory (g, indexed by object id)
// beside the tables for a large one
struct Scene {
  const float* s;
  int n_obj, n_light, max_depth;
  int has_reflect, has_refract, n_indirect;
  const float* g;
  Tables tb;
  Sky sky;

  __device__ __forceinline__ const float* light(int i) const { return s + HDR + LROW * i; }
  __device__ __forceinline__ const float* row(int o) const {
    return s + HDR + LROW * n_light + ROW * o;
  }
  __device__ __forceinline__ const float* row_by_id(int o) const {
    return g + HDR + LROW * n_light + ROW * o;
  }
  __device__ __forceinline__ int slots() const { return has_reflect + has_refract + n_indirect; }
};

// copies the packed scene's header, lights and n_rows object rows into
// shared memory; every thread of the block calls it
__device__ __forceinline__ void stage_scene(const float* __restrict__ scene, float* s,
                                            int n_rows, int n_light) {
  const int n = HDR + LROW * n_light + ROW * n_rows;
  for (int j = threadIdx.x; j < n; j += blockDim.x) s[j] = scene[j];
  __syncthreads();
}

// copies a large scene's fold buffer into shared memory at `dst` (16-byte
// aligned, like the buffer); every thread of the block calls it, before
// stage_scene and its barrier
__device__ __forceinline__ void stage_fold(const void* __restrict__ src, void* dst,
                                           int n_chunks) {
  const int n = (int)(fold_bytes(n_chunks) / sizeof(int4));
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    ((int4*)dst)[j] = __ldg((const int4*)src + j);
}

__host__ __device__ __forceinline__ size_t scene_bytes(int n_rows, int n_light) {
  return sizeof(float) * (HDR + LROW * (size_t)n_light + ROW * (size_t)n_rows);
}

// ---- arithmetic with or without contraction.  RN rounds every product
// and sum on its own, as the plain version does; without it the compiler
// contracts them into fused multiply-adds.  The large instances take RN
// wherever a ray's origin, direction or hit distance is made: a large field
// spans tens of units, where the 1e-5 offset of a secondary ray is a few
// float32 steps, so one rounding decides whether that ray hits the surface
// it left, and the path forks.  RN, and the explicit __fmul_rn/__fadd_rn
// calls further down (the refraction test, the shadow range, sky_lookup),
// matter only where the compiler may contract: in megakernel_linear.cu,
// scan_hit.cu and skybox.cu.  megakernel_tree.cu is built with -fmad=false,
// where they change nothing.
template <bool RN>
__device__ __forceinline__ float mul_(float x, float y) {
  if constexpr (RN) return __fmul_rn(x, y);
  else return x * y;
}
template <bool RN>
__device__ __forceinline__ float add_(float x, float y) {
  if constexpr (RN) return __fadd_rn(x, y);
  else return x + y;
}
template <bool RN>
__device__ __forceinline__ float sub_(float x, float y) {
  if constexpr (RN) return __fsub_rn(x, y);
  else return x - y;
}
template <bool RN>
__device__ __forceinline__ float dot_(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return add_<RN>(add_<RN>(mul_<RN>(ax, bx), mul_<RN>(ay, by)), mul_<RN>(az, bz));
}

// ---- a lane's identity (render/megakernel.py::_launch): a word a lane in
// each of four arrays (lens 0), or a render launch in factored form, P
// pixels (px, py) by S sample ids (aa) by `lens` lens samples, of which lane
// i is pixel i / (S lens), sample (i / lens) % S and lens sample i % lens
// (integrator.lane_ids' order; cam unused; fewer than 2^32 lanes)
struct Lanes {
  const uint32_t* px;
  const uint32_t* py;
  const uint32_t* aa;
  const uint32_t* cam;
  uint32_t samples, lens;
};

struct LaneId {
  uint32_t px, py, aa, cam;
};

__device__ __forceinline__ LaneId lane_id(const Lanes& l, long long lane) {
  if (l.lens == 0) return {__ldg(l.px + lane), __ldg(l.py + lane), __ldg(l.aa + lane),
                           __ldg(l.cam + lane)};
  const uint32_t i = (uint32_t)lane, q = i / l.lens, p = q / l.samples;
  return {__ldg(l.px + p), __ldg(l.py + p), __ldg(l.aa + (q - p * l.samples)), i - q * l.lens};
}

// ---- primary ray (integrator.primary_rays, cameras.project); `dof` for
// the depth-of-field camera
template <bool RN>
__device__ __forceinline__ Node primary_ray(const float* s, uint32_t px, uint32_t py,
                                            uint32_t a_id, uint32_t c_id, uint32_t seed,
                                            bool dof) {
  // the jitter's keys hash (px, py, aa), the path's (px, py, aa, cam):
  // both sponges of a seed word share their first three absorptions
  uint32_t jk1, jk2;
  Node e;
  primary_keys(seed ^ 0x243F6A88u, px, py, a_id, c_id, jk1, e.k1);
  primary_keys(seed ^ 0x85A308D3u, px, py, a_id, c_id, jk2, e.k2);
  const float u = draw(jk1, jk2, PURPOSE_AA_X);
  const float v = draw(jk1, jk2, PURPOSE_AA_Y);
  const float pos_x = (((float)(int)px + u) - s[H_HALFW]) * s[H_SCALE];
  const float pos_y = (((float)(int)py + v) - s[H_HALFH]) * s[H_SCALE];

  const float* m = s + H_CAM_M;
  float dx = add_<RN>(add_<RN>(mul_<RN>(m[0], pos_x), mul_<RN>(m[1], pos_y)), m[2]);
  float dy = add_<RN>(add_<RN>(mul_<RN>(m[3], pos_x), mul_<RN>(m[4], pos_y)), m[5]);
  float dz = add_<RN>(add_<RN>(mul_<RN>(m[6], pos_x), mul_<RN>(m[7], pos_y)), m[8]);
  float ox = s[H_CAM_POS], oy = s[H_CAM_POS + 1], oz = s[H_CAM_POS + 2];
  if (dof) {
    // camera.rs:110-121: d un-normalized, lens point uniform on a disc
    const float fr = s[H_FOCUS] / s[H_IM_DIST];
    const float fx = add_<RN>(ox, mul_<RN>(dx, fr)), fy = add_<RN>(oy, mul_<RN>(dy, fr)),
                fz = add_<RN>(oz, mul_<RN>(dz, fr));
    const float theta = draw(e.k1, e.k2, PURPOSE_LENS_THETA) * TWO_PI;
    const float r = sqrtf(draw(e.k1, e.k2, PURPOSE_LENS_R)) * s[H_APERTURE];
    const float lx = cosf(theta) * r, ly = sinf(theta) * r;
    ox = (ox + dx) + dot_<RN>(m[0], m[1], m[2], lx, ly, 0.0f);
    oy = (oy + dy) + dot_<RN>(m[3], m[4], m[5], lx, ly, 0.0f);
    oz = (oz + dz) + dot_<RN>(m[6], m[7], m[8], lx, ly, 0.0f);
    dx = fx - ox;
    dy = fy - oy;
    dz = fz - oz;
  }
  const float dinv = rsqrtf(dot_<RN>(dx, dy, dz, dx, dy, dz));
  e.ox = ox;
  e.oy = oy;
  e.oz = oz;
  e.dx = dx * dinv;
  e.dy = dy * dinv;
  e.dz = dz * dinv;
  e.sig = 1.0f;
  e.tx = e.ty = e.tz = 1.0f;
  e.live = true;
  return e;
}

// ---- intersection (ops/intersect.py::_object_t): t and validity of one
// sphere (center, r * r), of one plane (normal, p.n).  The folds over a
// large scene's table have their own sphere test (sphere_row_t, below).
__device__ __forceinline__ bool sphere_t(float cx, float cy, float cz, float rr, float ox,
                                         float oy, float oz, float dx, float dy, float dz,
                                         float a4, float inv2a, float& t) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = 2.0f * dot_<false>(dx, dy, dz, ocx, ocy, ocz);
  const float cc = dot_<false>(ocx, ocy, ocz, ocx, ocy, ocz) - rr;
  const float disc = b * b - a4 * cc;
  // the root and its square root only where a thread of the warp may hit
  if (!(disc > 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * inv2a;
  t = t1 > 0.0f ? t1 : (-b + sq) * inv2a;
  return t > 0.0f;
}

template <bool RN>
__device__ __forceinline__ bool plane_t(float qx, float qy, float qz, float p_dot_n, float ox,
                                        float oy, float oz, float dx, float dy, float dz,
                                        float& t) {
  const float denom = dot_<RN>(dx, dy, dz, qx, qy, qz);
  const float numer = sub_<RN>(p_dot_n, dot_<RN>(ox, oy, oz, qx, qy, qz));
  const bool ok = denom != 0.0f;
  t = numer / (ok ? denom : 1.0f);
  return ok && t > 0.0f;
}

// t and validity of one object row of a small scene
__device__ __forceinline__ bool object_t(const float* r, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float a4, float inv2a,
                                         float& t) {
  if (r[R_SPH] > 0.5f)
    return sphere_t(r[R_P], r[R_P + 1], r[R_P + 2], r[R_PRE], ox, oy, oz, dx, dy, dz, a4,
                    inv2a, t);
  return plane_t<false>(r[R_Q], r[R_Q + 1], r[R_Q + 2], r[R_PRE], ox, oy, oz, dx, dy, dz, t);
}

__device__ __forceinline__ float safe_inv2a(float a) { return 0.5f / (a > 0.0f ? a : 1.0f); }

// The two queries over a small scene's rows in shared memory, one loop over
// the rows in scene order (every thread of a warp tests the same object, a
// broadcast, so the instructions of one test times the objects are the
// work).  A sphere's r * r and a plane's p.n come ready (R_PRE), rounded as
// the plain version rounds them.  The loops stay rolled: an unrolled body
// with its remainder costs registers, and with them blocks an SM.
//
// closest hit: running minimum, the first minimum in scene order wins; a
// miss leaves `best` at the first live object (the reference's miss row)
__device__ __forceinline__ bool closest_hit(const Scene& sc, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float& t_best,
                                            int& best) {
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv2a = safe_inv2a(a), a4 = 4.0f * a;
  t_best = INFINITY;
  best = 0;
  bool hit = false;
#pragma unroll 1
  for (int o = 0; o < sc.n_obj; ++o) {
    float t;
    const bool valid = object_t(sc.row(o), ox, oy, oz, dx, dy, dz, a4, inv2a, t);
    if (valid && t < t_best) {
      t_best = t;
      best = o;
    }
    hit = hit || valid;
  }
  return hit;
}

// ops/intersect.py::occluded_v: any hit, within range when the light has
// one (t*t < sq_range, computed uncontracted)
__device__ __forceinline__ bool occluded(const Scene& sc, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float sq_range,
                                         bool has_range) {
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv2a = safe_inv2a(a), a4 = 4.0f * a;
#pragma unroll 1
  for (int o = 0; o < sc.n_obj; ++o) {
    float t;
    if (object_t(sc.row(o), ox, oy, oz, dx, dy, dz, a4, inv2a, t)
        && (!has_range || __fmul_rn(t, t) < sq_range))
      return true;
  }
  return false;
}

// ---- the same two queries over the unified table of a large scene
// (ops/intersect_scan.py::scan_hit_reference): the minimum of (t, object
// id) over the valid rows, and whether any row is hit in range.
//
// What bounds them on an H100 is instruction throughput: a sphere test is some
// thirty dependent float32 instructions per (ray, row), every product and
// sum rounded on its own (RN, above: seen from tens of units away a unit
// sphere's discriminant cancels, a contracted b*b - 4ac moves t by 1e-5
// relative and every later bounce with it), and the table is a few tens of
// KB that every ray reads.  Tensor cores do not serve it: the products have
// depth 3 and must round as the plain float32 version's do.  What the
// design does about it:
//  - per row: 4a is made once per ray and r*r once per scene (the table's
//    fourth column, the bits of float32(r) * float32(r)); the square root
//    and the roots are behind the branch on disc > 0, so rows that no
//    thread of the warp can hit skip them; the row's id is read only when
//    it improves the minimum;
//  - the table lies in shared memory when that leaves the SM its blocks
//    (SH; ops/intersect_scan.py::fold_in_shared), staged once per block,
//    and is read through the read-only cache when it does not;
//  - a ray skips the sphere chunks whose bounding sphere it cannot enter
//    before its running best hit (chunk_bound, chunk_may_enter);
//  - the fold has two forms.  Every thread walks the table for its own ray
//    (fold_closest_lane, fold_any_lane; every thread reads the same row, a
//    broadcast): the warp then runs the union of the chunks its rays
//    enter, which is a ray's own on camera rays and two to four times
//    that after a diffuse bounce.  Or the warp folds its rays one at a time
//    (fold_closest_warp, fold_any_warp): the ray goes to every thread by
//    shuffle, thread j tests row j of a chunk (one conflict-free 16-byte
//    load each), and a warp reduction takes the minimum; the work is then
//    the sum of the rays' own chunks, at a few more instructions per
//    chunk.  A probe of eight chunk bounds says per warp and query which
//    form is the cheaper (warp_rays_part).  The minimum of (t, id) does not
//    depend on the order of the rows, so both give the same result to the
//    bit.

// a word, a row or a bound of the table, from shared memory or through the
// read-only cache
template <bool SH, class T>
__device__ __forceinline__ T tab_load(const T* p) {
  if constexpr (SH) return *p;
  else return __ldg(p);
}
template <bool SH>
__device__ __forceinline__ float4 tab_row(const Tables& tb, int row) {
  return tab_load<SH>(tb.tab + row);
}
template <bool SH>
__device__ __forceinline__ float4 tab_bound(const Tables& tb, int c) {
  return tab_load<SH>(tb.bnd + c);
}

// a ray and what the tests need of it once: a = d.d, 0.5 / a and 4a
struct RayQ {
  float ox, oy, oz, dx, dy, dz, a, inv2a, a4;
};

__device__ __forceinline__ RayQ make_ray(float ox, float oy, float oz, float dx, float dy,
                                         float dz) {
  const float a = dot_<true>(dx, dy, dz, dx, dy, dz);
  return RayQ{ox, oy, oz, dx, dy, dz, a, safe_inv2a(a), __fmul_rn(4.0f, a)};
}

// t and validity of one sphere row (cx, cy, cz, r*r), in the plain scan's
// order of operations.  A pad row's -inf in place of r*r makes disc -inf
// (NaN for a zero direction), never > 0.
__device__ __forceinline__ bool sphere_row_t(const float4 r, const RayQ& q, float& t) {
  const float ocx = q.ox - r.x, ocy = q.oy - r.y, ocz = q.oz - r.z;
  const float b = __fmul_rn(2.0f, dot_<true>(q.dx, q.dy, q.dz, ocx, ocy, ocz));
  const float cc = __fsub_rn(dot_<true>(ocx, ocy, ocz, ocx, ocy, ocz), r.w);
  const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(q.a4, cc));
  if (!(disc > 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * q.inv2a;
  t = t1 > 0.0f ? t1 : (-b + sq) * q.inv2a;
  return t > 0.0f;
}

__device__ __forceinline__ bool plane_row_t(const float4 r, const RayQ& q, float& t) {
  return plane_t<true>(r.x, r.y, r.z, r.w, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, t);
}

// the running minimum of (t, id): a valid row's t and the row it came from
template <bool SH>
__device__ __forceinline__ void take_min(const Tables& tb, int row, float t, float& t_best,
                                         int& gid) {
  if (t <= t_best) {
    const int g = tab_load<SH>(tb.ids + row);
    if (t < t_best || g < gid) {
      t_best = t;
      gid = g;
    }
  }
}

// Whether a sphere chunk may hold a hit in front of the ray's origin and
// not beyond a limit: the ray enters the chunk's bounding sphere in that
// range.  Skipping the chunks that fail changes no result: a hit of a
// member sphere implies an earlier entry into the bound.  The tests take
// slack relative to the quantities that carry the rounding error of
// b*b - 4ac, which keeps a far grazing ray from skipping a real hit.
// chunk_bound does the part that does not depend on the limit and gives
// the entry distance and its slack; chunk_may_enter holds them against the
// limit, which falls as the fold goes on.
__device__ __forceinline__ bool chunk_bound(const float4 bs, const RayQ& q, float& t_enter,
                                            float& margin) {
  const float ocx = q.ox - bs.x, ocy = q.oy - bs.y, ocz = q.oz - bs.z;
  const float b = 2.0f * (q.dx * ocx + q.dy * ocy + q.dz * ocz);
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - bs.w * bs.w;
  const float disc = b * b - 4.0f * q.a * cc;
  const bool pos = disc > -1e-5f * (b * b);
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  margin = 1e-5f * fabsf(b) * q.inv2a + 1e-4f;
  t_enter = (-b - sq) * q.inv2a;
  return pos && (-b + sq) * q.inv2a > -margin;
}
__device__ __forceinline__ bool chunk_may_enter(float t_enter, float margin, float t_limit) {
  return t_enter <= t_limit + margin;
}

// with a range (t*t < sq_range, uncontracted), sphere chunks entered only
// beyond it are skipped: t*t < sq_range implies t < 1.00001 * sqrt(sq_range)
__device__ __forceinline__ float shadow_limit(float sq_range, bool has_range) {
  return has_range ? sqrtf(sq_range) * 1.00001f : INFINITY;
}

// closest hit, every thread for its own ray; gid is ID_SENTINEL on a miss
template <bool SH>
__device__ __forceinline__ void fold_closest_lane(const Tables& tb, const RayQ& q,
                                                  float& t_best, int& gid) {
  t_best = INFINITY;
  gid = ID_SENTINEL;
  for (int c = 0; c < tb.n_sph_chunks; ++c) {
    float t_enter, margin;
    if (!chunk_bound(tab_bound<SH>(tb, c), q, t_enter, margin)
        || !chunk_may_enter(t_enter, margin, t_best))
      continue;
    for (int row = c * CHUNK; row < (c + 1) * CHUNK; ++row) {
      float t;
      if (sphere_row_t(tab_row<SH>(tb, row), q, t)) take_min<SH>(tb, row, t, t_best, gid);
    }
  }
  for (int row = tb.n_sph_chunks * CHUNK; row < tb.n_chunks * CHUNK; ++row) {
    float t;
    if (plane_row_t(tab_row<SH>(tb, row), q, t)) take_min<SH>(tb, row, t, t_best, gid);
  }
}

// any hit in range, every thread for its own ray: in range iff the closest
// hit is, so the first one found answers
template <bool SH>
__device__ __forceinline__ bool fold_any_lane(const Tables& tb, const RayQ& q, float sq_range,
                                              bool has_range) {
  const float t_limit = shadow_limit(sq_range, has_range);
  for (int c = 0; c < tb.n_sph_chunks; ++c) {
    float t_enter, margin;
    if (!chunk_bound(tab_bound<SH>(tb, c), q, t_enter, margin)
        || !chunk_may_enter(t_enter, margin, t_limit))
      continue;
    for (int row = c * CHUNK; row < (c + 1) * CHUNK; ++row) {
      float t;
      if (sphere_row_t(tab_row<SH>(tb, row), q, t)
          && (!has_range || __fmul_rn(t, t) < sq_range))
        return true;
    }
  }
  for (int row = tb.n_sph_chunks * CHUNK; row < tb.n_chunks * CHUNK; ++row) {
    float t;
    if (plane_row_t(tab_row<SH>(tb, row), q, t) && (!has_range || __fmul_rn(t, t) < sq_range))
      return true;
  }
  return false;
}

// the threads of the warp that are at this point together (`mask`), this
// thread's rank among them and their number.  The warp folds work for any
// such set: a render kernel's threads leave their paths at different
// times.  FULL is the whole warp, whose ranks and size the compiler knows.
template <bool FULL>
struct Peers {
  unsigned mask;
  int lane, rank, size;
  __device__ __forceinline__ explicit Peers(unsigned m) {
    mask = FULL ? 0xFFFFFFFFu : m;
    lane = threadIdx.x & 31;
    rank = FULL ? lane : __popc(m & ((1u << lane) - 1u));
    size = FULL ? 32 : __popc(m);
  }
  // the rank of the thread in lane `l`
  __device__ __forceinline__ int rank_of(int l) const {
    return FULL ? l : __popc(mask & ((1u << l) - 1u));
  }
};
template <bool FULL>
__device__ __forceinline__ RayQ ray_of(const Peers<FULL>& p, const RayQ& q, int src) {
  return RayQ{__shfl_sync(p.mask, q.ox, src), __shfl_sync(p.mask, q.oy, src),
              __shfl_sync(p.mask, q.oz, src), __shfl_sync(p.mask, q.dx, src),
              __shfl_sync(p.mask, q.dy, src), __shfl_sync(p.mask, q.dz, src),
              __shfl_sync(p.mask, q.a, src),  __shfl_sync(p.mask, q.inv2a, src),
              __shfl_sync(p.mask, q.a4, src)};
}

// closest hit, the warp for one ray after the other.  For each ray: the
// threads test one chunk bound each, a ballot names the chunks to enter;
// for each of those in table order the threads test its 32 rows, a warp
// minimum of the threads' running t gives the new limit, and the ballot is
// taken again against it, so a ray enters exactly the chunks it would
// enter alone.  Each thread keeps the minimum of (t, id) over the rows it
// tested; two warp reductions at the end give the ray's.  t > 0 on every
// valid row, so floats compare as their bits.
template <bool SH, bool FULL>
__device__ __forceinline__ void fold_closest_warp(const Tables& tb, unsigned mask,
                                                  const RayQ& mine, float& t_best, int& gid) {
  const Peers<FULL> p(mask);
  t_best = INFINITY;
  gid = ID_SENTINEL;
  for (unsigned todo = p.mask; todo != 0u; todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    const RayQ q = ray_of(p, mine, src);
    float tj = INFINITY, t_warp = INFINITY;
    int gj = ID_SENTINEL;
    for (int base = 0; base < tb.n_sph_chunks; base += p.size) {
      const int c = base + p.rank;
      float t_enter = 0.0f, margin = 0.0f;
      const bool may = c < tb.n_sph_chunks
                       && chunk_bound(tab_bound<SH>(tb, c), q, t_enter, margin);
      unsigned cand = __ballot_sync(p.mask, may && chunk_may_enter(t_enter, margin, t_warp));
      while (cand != 0u) {
        const int owner = __ffs(cand) - 1;
        const int first = (base + p.rank_of(owner)) * CHUNK;
        bool got = false;
        for (int k = p.rank; k < CHUNK; k += p.size) {
          float t;
          if (sphere_row_t(tab_row<SH>(tb, first + k), q, t)) {
            take_min<SH>(tb, first + k, t, tj, gj);
            got = true;
          }
        }
        cand &= ~((2u << owner) - 1u);  // the chunks behind this one
        if (__any_sync(p.mask, got)) {  // most chunks a ray enters hold no hit
          t_warp = __uint_as_float(__reduce_min_sync(p.mask, __float_as_uint(tj)));
          cand &= __ballot_sync(p.mask, chunk_may_enter(t_enter, margin, t_warp));
        }
      }
    }
    for (int row = tb.n_sph_chunks * CHUNK + p.rank; row < tb.n_chunks * CHUNK; row += p.size) {
      float t;
      if (plane_row_t(tab_row<SH>(tb, row), q, t)) take_min<SH>(tb, row, t, tj, gj);
    }
    const unsigned t_bits = __reduce_min_sync(p.mask, __float_as_uint(tj));
    const int g = __reduce_min_sync(p.mask, __float_as_uint(tj) == t_bits ? gj : ID_SENTINEL);
    if (p.lane == src) {
      t_best = __uint_as_float(t_bits);
      gid = g;
    }
  }
}

// any hit in range, the warp for one ray after the other; a ray's fold
// stops at the first chunk in which any thread found a hit
template <bool SH, bool FULL>
__device__ __forceinline__ bool fold_any_warp(const Tables& tb, unsigned mask, const RayQ& mine,
                                              float sq_range, bool has_range) {
  const Peers<FULL> p(mask);
  bool blocked = false;
  for (unsigned todo = p.mask; todo != 0u; todo &= todo - 1u) {
    const int src = __ffs(todo) - 1;
    const RayQ q = ray_of(p, mine, src);
    const float sq_r = __shfl_sync(p.mask, sq_range, src);
    const bool has_r = __shfl_sync(p.mask, (int)has_range, src) != 0;
    const float t_limit = shadow_limit(sq_r, has_r);
    bool found = false;
    for (int base = 0; base < tb.n_sph_chunks && !found; base += p.size) {
      const int c = base + p.rank;
      float t_enter = 0.0f, margin = 0.0f;
      const bool may = c < tb.n_sph_chunks
                       && chunk_bound(tab_bound<SH>(tb, c), q, t_enter, margin)
                       && chunk_may_enter(t_enter, margin, t_limit);
      for (unsigned cand = __ballot_sync(p.mask, may); cand != 0u && !found; cand &= cand - 1u) {
        const int owner = __ffs(cand) - 1;
        const int first = (base + p.rank_of(owner)) * CHUNK;
        bool f = false;
        for (int k = p.rank; k < CHUNK; k += p.size) {
          float t;
          f = f || (sphere_row_t(tab_row<SH>(tb, first + k), q, t)
                    && (!has_r || __fmul_rn(t, t) < sq_r));
        }
        found = __any_sync(p.mask, f);
      }
    }
    if (!found) {
      bool f = false;
      for (int row = tb.n_sph_chunks * CHUNK + p.rank; row < tb.n_chunks * CHUNK;
           row += p.size) {
        float t;
        f = f || (plane_row_t(tab_row<SH>(tb, row), q, t)
                  && (!has_r || __fmul_rn(t, t) < sq_r));
      }
      found = __any_sync(p.mask, f);
    }
    if (p.lane == src) blocked = found;
  }
  return blocked;
}

// Whether the rays of the threads that are here together part, so that the
// warp does better to fold them one at a time.  Every thread holds its own
// ray against a sample of up to PROBE_CHUNKS chunk bounds spread over the
// table; of the sampled chunks that any ray may enter, the rays that may
// enter it are counted.  Rays that run together (a launch's camera rays)
// enter the same chunks, and the share is near 1; rays that part (after a
// diffuse bounce) leave it near the share of the table that one ray
// crosses.  Folding every thread's own ray costs the union of the chunks,
// folding them in turn their sum, so the warp folds together when the
// share is at most PROBE_SHARE_NUM / PROBE_SHARE_DEN (measured: near 1 on
// camera rays, 0.2-0.6 after a bounce), and when at least PROBE_MIN_RAYS
// rays are here: the union of fewer is hardly smaller than their sum, and
// the warp's fold pays for its ballots and reductions.
constexpr int PROBE_CHUNKS = 8;
constexpr int PROBE_SHARE_NUM = 3, PROBE_SHARE_DEN = 4;
constexpr int PROBE_MIN_RAYS = 4;
template <bool SH>
__device__ __forceinline__ bool warp_rays_part(const Tables& tb, unsigned mask, const RayQ& q) {
  if (__popc(mask) < PROBE_MIN_RAYS) return false;
  const int probes = min(tb.n_sph_chunks, PROBE_CHUNKS);
  int entering = 0, entered = 0;
  for (int k = 0; k < probes; ++k) {
    float t_enter, margin;
    const unsigned who = __ballot_sync(
        mask, chunk_bound(tab_bound<SH>(tb, k * tb.n_sph_chunks / probes), q, t_enter, margin));
    entering += __popc(who);
    entered += who != 0u;
  }
  return entered > 0 && PROBE_SHARE_DEN * entering <= PROBE_SHARE_NUM * entered * __popc(mask);
}

// the two queries as the kernels call them.  The threads that fold together
// are those that arrive together (__activemask), whoever they are: a ray's
// result never depends on which rays share its fold, nor on their number,
// since each thread's ray is folded whole by either form and the minimum of
// (t, id) does not depend on the order of the rows.  That must stay so: an
// early exit taken across rays, or a result read from a peer that may not
// be there, would make correctness hang on the compiler keeping the warp
// converged.  Only the speed does now (the render kernels start each round
// together, so that a fold finds the warp's live threads and not a part).
template <bool SH>
__device__ __forceinline__ bool fold_closest(const Tables& tb, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float& t_best,
                                             int& gid) {
  const RayQ q = make_ray(ox, oy, oz, dx, dy, dz);
  const unsigned mask = __activemask();
  if (warp_rays_part<SH>(tb, mask, q)) {
    if (mask == 0xFFFFFFFFu)
      fold_closest_warp<SH, true>(tb, mask, q, t_best, gid);
    else
      fold_closest_warp<SH, false>(tb, mask, q, t_best, gid);
  } else {
    fold_closest_lane<SH>(tb, q, t_best, gid);
  }
  return gid != ID_SENTINEL;
}
template <bool SH>
__device__ __forceinline__ bool fold_any(const Tables& tb, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float sq_range,
                                         bool has_range) {
  const RayQ q = make_ray(ox, oy, oz, dx, dy, dz);
  const unsigned mask = __activemask();
  if (warp_rays_part<SH>(tb, mask, q))
    return mask == 0xFFFFFFFFu ? fold_any_warp<SH, true>(tb, mask, q, sq_range, has_range)
                               : fold_any_warp<SH, false>(tb, mask, q, sq_range, has_range);
  return fold_any_lane<SH>(tb, q, sq_range, has_range);
}

// ---- where shade_node takes the answers to its two questions, the closest
// hit of the node's ray and, for each light, whether its shadow ray is
// blocked.  A policy class: the fused render kernels ask the scene
// (SceneAnswers, below), the ring's kernels read answers that the ring
// filled in between launches (ring_shade.cu).  A policy has
//   closest(sc, e, t, best): whether the ray hits, its t and the winner;
//   row(sc, best): the winner's ROW floats;
//   blocked(sc, li, sx, sy, sz, lx, ly, lz, sq, has_range): light li's
//     shadow ray (origin, direction, squared range) is blocked;
//   GLOBAL: the rows are a large scene's (no R_PRE constant) and the hit
//     record takes RN arithmetic;
//   TO_LIGHTS: shade_node returns after the lights (the ring's first pass,
//     which only wants the shadow rays).
// LARGE (1: the table in device memory, 2: staged in shared memory; 0 for
// a small scene) answers closest hit and the shadow queries by the folds
// over the scene's tables and reads the winner's row from device memory by
// object id; the small instances keep the loops over shared memory.
template <int LARGE>
struct SceneAnswers {
  static constexpr bool GLOBAL = LARGE != 0;
  static constexpr bool TO_LIGHTS = false;
  __device__ __forceinline__ bool closest(const Scene& sc, const Node& e, float& t_best,
                                          int& best) const {
    if constexpr (LARGE != 0)
      return fold_closest<LARGE == 2>(sc.tb, e.ox, e.oy, e.oz, e.dx, e.dy, e.dz, t_best, best);
    else
      return closest_hit(sc, e.ox, e.oy, e.oz, e.dx, e.dy, e.dz, t_best, best);
  }
  __device__ __forceinline__ const float* row(const Scene& sc, int best) const {
    if constexpr (LARGE != 0)
      return sc.row_by_id(best);
    else
      return sc.row(best);
  }
  __device__ __forceinline__ bool blocked(const Scene& sc, int, float sx, float sy, float sz,
                                          float lx, float ly, float lz, float sq,
                                          bool has_range) const {
    if constexpr (LARGE != 0)
      return fold_any<LARGE == 2>(sc.tb, sx, sy, sz, lx, ly, lz, sq, has_range);
    else
      return occluded(sc, sx, sy, sz, lx, ly, lz, sq, has_range);
  }
};

// ---- shading of one node (integrator.tree_loop_node without the routing):
// closest hit, local radiance times throughput into (cx, cy, cz), and
// emit(slot, child) for every live child slot in slot order (reflect,
// refract, indirect).  The node's entry must be live.  LIT = false is the
// linear kernel's lean instance: it leaves out the code of lights, Fresnel
// factors and reflect/refract slots, takes the significance as 1, and
// takes at most one indirect slot.  That is exact for a linear
// scene without lights and without those slots: no material is then
// Transparent (builder.build_scene), the Fresnel factor scales only
// specular light and the reflect child, the only children, indirect ones,
// keep their parent's significance, which starts at 1, and a linear scene
// has at most one slot.  It keeps the IndirectPhong-only chain short.
// `ask` answers the closest hit and the shadow queries (SceneAnswers, or
// the ring's buffers).  With SceneAnswers of a large scene every thread of
// a warp whose path is still alive calls this together, whatever its
// depth: the folds share their work across the warp.  SKY takes a miss's
// radiance from the skybox (sky_lookup); the instances without it carry
// none of its code.
template <bool LIT, bool SKY, class Ask, class Emit>
__device__ __forceinline__ void shade_node(const Scene& sc, const Ask& ask, const Node& e,
                                           int depth, float& cx, float& cy, float& cz,
                                           Emit&& emit) {
  float t_best;
  int best;
  const bool hit = ask.closest(sc, e, t_best, best);
  if (!hit) {  // background; a miss spawns nothing
    float bx, by, bz;
    if constexpr (SKY) {
      sky_lookup(sc.sky, e.dx, e.dy, e.dz, bx, by, bz);
    } else {
      bx = sc.s[H_BG];
      by = sc.s[H_BG + 1];
      bz = sc.s[H_BG + 2];
    }
    cx = e.tx * bx;
    cy = e.ty * by;
    cz = e.tz * bz;
    return;
  }
  const float* r = ask.row(sc, best);  // the one load of the winner's row
  if (depth > sc.max_depth) {  // ambient only, no recursion (raytrace.rs:33)
    cx = e.tx * r[R_AMB];
    cy = e.ty * r[R_AMB + 1];
    cz = e.tz * r[R_AMB + 2];
    return;
  }
  const float sig = LIT ? e.sig : 1.0f;

  // hit record: point, normal, snap onto the surface; RN in the large
  // instances, like the origins of the shadow and child rays
  constexpr bool RN = Ask::GLOBAL;
  float ptx = add_<RN>(e.ox, mul_<RN>(e.dx, t_best));
  float pty = add_<RN>(e.oy, mul_<RN>(e.dy, t_best));
  float ptz = add_<RN>(e.oz, mul_<RN>(e.dz, t_best));
  float nx, ny, nz;
  if (r[R_SPH] > 0.5f) {
    const float relx = ptx - r[R_P], rely = pty - r[R_P + 1], relz = ptz - r[R_P + 2];
    const float nrm2 = dot_<RN>(relx, rely, relz, relx, rely, relz);
    const float inv = rsqrtf(nrm2 > 0.0f ? nrm2 : 1.0f);
    nx = relx * inv;
    ny = rely * inv;
    nz = relz * inv;
    const float k = r[R_Q] * inv;
    ptx = add_<RN>(ptx - relx, mul_<RN>(relx, k));
    pty = add_<RN>(pty - rely, mul_<RN>(rely, k));
    ptz = add_<RN>(ptz - relz, mul_<RN>(relz, k));
  } else {
    nx = r[R_Q];
    ny = r[R_Q + 1];
    nz = r[R_Q + 2];
    const float nn = dot_<RN>(nx, ny, nz, nx, ny, nz);
    // p.n: ready in a small scene's row, in the same rounding as RN's
    const float p_dot_n =
        Ask::GLOBAL ? dot_<RN>(r[R_P], r[R_P + 1], r[R_P + 2], nx, ny, nz) : r[R_PRE];
    const float dist = sub_<RN>(dot_<RN>(ptx, pty, ptz, nx, ny, nz), p_dot_n)
                       / (nn > 0.0f ? nn : 1.0f);
    const float sc_ = nn > 0.0f ? dist : 0.0f;
    ptx = sub_<RN>(ptx, mul_<RN>(nx, sc_));
    pty = sub_<RN>(pty, mul_<RN>(ny, sc_));
    ptz = sub_<RN>(ptz, mul_<RN>(nz, sc_));
  }
  // the origin of a secondary ray: the hit point moved 1e-5 along the ray
  const auto off = [](float p, float d) { return add_<RN>(p, mul_<RN>(d, OFFSET)); };

  // the normal flipped toward the viewer
  const float nd = dot_<RN>(nx, ny, nz, e.dx, e.dy, e.dz);
  const float nfx = nd > 0.0f ? -nx : nx;
  const float nfy = nd > 0.0f ? -ny : ny;
  const float nfz = nd > 0.0f ? -nz : nz;
  const bool is_fre = LIT && r[R_FRE] > 0.5f, is_tra = LIT && r[R_TRA] > 0.5f;
  const bool is_ind = r[R_IND] > 0.5f;

  // fresnel and refraction (materials.shade); other materials take the
  // factor 1, which multiplies exactly
  float fres = 1.0f;
  bool refract_ok = false;
  float rfx = 0.0f, rfy = 0.0f, rfz = 0.0f;
  if (LIT && (is_fre || is_tra)) {
    const float ior = r[R_IOR];
    float r0 = (ior - 1.0f) / (ior + 1.0f);
    r0 = r0 * r0;
    const float ior_safe = ior != 0.0f ? ior : 1.0f;
    const float n_ratio = nd > 0.0f ? ior : 1.0f / ior_safe;
    const float sin2 = __fmul_rn(__fmul_rn(n_ratio, n_ratio), __fsub_rn(1.0f, __fmul_rn(nd, nd)));
    refract_ok = sin2 < 1.0f && ior != 0.0f;
    const float cos_t = refract_ok ? sqrtf(fmaxf(1.0f - sin2, 0.0f)) : 0.0f;
    const float n_r = refract_ok ? n_ratio : 0.0f;
    const float anr = add_<RN>(mul_<RN>(n_r, fabsf(nd)), cos_t);
    rfx = sub_<RN>(mul_<RN>(e.dx, n_r), mul_<RN>(nfx, anr));
    rfy = sub_<RN>(mul_<RN>(e.dy, n_r), mul_<RN>(nfy, anr));
    rfz = sub_<RN>(mul_<RN>(e.dz, n_r), mul_<RN>(nfz, anr));
    const float omcos_transp =
        nd > 0.0f ? (refract_ok ? 1.0f - (nfx * rfx + nfy * rfy + nfz * rfz) : 0.0f)
                  : 1.0f - fabsf(nd);
    const float omcos = is_fre ? 1.0f - fabsf(nd) : omcos_transp;
    const float omcos2 = omcos * omcos;
    const float schlick = fminf(r0 + (1.0f - r0) * omcos2 * omcos2 * omcos, 1.0f);
    fres = (is_tra && !refract_ok) ? 1.0f : schlick;
  }

  // significance gates
  const float diff_sig = r[R_DIFF] + r[R_DIFF + 1] + r[R_DIFF + 2];
  const float spec_sig = r[R_SPEC] + r[R_SPEC + 1] + r[R_SPEC + 2];
  const float min_sig = sc.s[H_MIN_SIG];
  const bool diffuse_gate = diff_sig * sig > min_sig && !is_tra;
  const bool spec_gate = (spec_sig * fres) * sig > min_sig;

  float emx = r[R_AMB], emy = r[R_AMB + 1], emz = r[R_AMB + 2];
  // direct lighting; a light whose both terms are gated off adds exact zeros
  for (int li = 0; LIT && li < sc.n_light && (diffuse_gate || spec_gate); ++li) {
    const float* L = sc.light(li);
    const int type = (int)L[L_TYPE];
    float lx, ly, lz, sq = 0.0f;
    bool has_range = true;
    if (type == LIGHT_DIRECTIONAL) {
      lx = 0.0f - L[L_E1];
      ly = 0.0f - L[L_E1 + 1];
      lz = 0.0f - L[L_E1 + 2];
      has_range = false;
    } else {
      float px = L[L_P], py = L[L_P + 1], pz = L[L_P + 2];
      if (type == LIGHT_AREA) {
        const float u = draw(e.k1, e.k2, PURPOSE_LIGHT_U + 2u * li);
        const float v = draw(e.k1, e.k2, PURPOSE_LIGHT_V + 2u * li);
        px = px + L[L_E1] * u + L[L_E2] * v;
        py = py + L[L_E1 + 1] * u + L[L_E2 + 1] * v;
        pz = pz + L[L_E1 + 2] * u + L[L_E2 + 2] * v;
      }
      const float rx = px - ptx, ry = py - pty, rz = pz - ptz;
      sq = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz));
      const float il = 1.0f / sqrtf(sq > 0.0f ? sq : 1.0f);
      lx = rx * il;
      ly = ry * il;
      lz = rz * il;
    }
    const float sx = off(ptx, lx), sy = off(pty, ly), sz = off(ptz, lz);
    if (ask.blocked(sc, li, sx, sy, sz, lx, ly, lz, sq, has_range)) continue;
    const float* lc = L + L_COLOR;
    if (diffuse_gate) {
      const float lam = fmaxf(lx * nfx + ly * nfy + lz * nfz, 0.0f) * INV_PI;
      emx = emx + r[R_DIFF] * lc[0] * lam;
      emy = emy + r[R_DIFF + 1] * lc[1] * lam;
      emz = emz + r[R_DIFF + 2] * lc[2] * lam;
    }
    if (spec_gate) {
      // half vector, normalized with a zero guard
      const float hx = lx - e.dx, hy = ly - e.dy, hz = lz - e.dz;
      const float h2 = hx * hx + hy * hy + hz * hz;
      const float hi = h2 > 0.0f ? rsqrtf(h2) : 0.0f;
      const float nh = nfx * (hx * hi) + nfy * (hy * hi) + nfz * (hz * hi);
      const float ws = powf(fmaxf(nh, 0.0f), r[R_EXP]) * fres;
      emx = emx + r[R_SPEC] * lc[0] * ws;
      emy = emy + r[R_SPEC + 1] * lc[1] * ws;
      emz = emz + r[R_SPEC + 2] * lc[2] * ws;
    }
  }
  if constexpr (Ask::TO_LIGHTS) return;
  cx = e.tx * emx;
  cy = e.ty * emy;
  cz = e.tz * emz;

  // child slots, numbered reflect, refract, indirect
  int slot = 0;
  if (LIT && sc.has_reflect) {
    if (spec_gate && !is_ind) {
      const float rdn = mul_<RN>(2.0f, dot_<RN>(e.dx, e.dy, e.dz, nfx, nfy, nfz));
      const float rx = sub_<RN>(e.dx, mul_<RN>(nfx, rdn)), ry = sub_<RN>(e.dy, mul_<RN>(nfy, rdn)),
                  rz = sub_<RN>(e.dz, mul_<RN>(nfz, rdn));
      emit(slot, off(ptx, rx), off(pty, ry), off(ptz, rz), rx, ry, rz,
           sig * spec_sig * fres, r[R_SPEC] * fres, r[R_SPEC + 1] * fres, r[R_SPEC + 2] * fres);
    }
    ++slot;
  }
  if (LIT && sc.has_refract) {
    if (is_tra && fres < 1.0f && refract_ok) {
      const float omf = fminf(1.0f - fres, 1.0f);
      const float n2 = dot_<RN>(rfx, rfy, rfz, rfx, rfy, rfz);
      const float ri = n2 > 0.0f ? rsqrtf(n2) : 0.0f;
      const float rx = rfx * ri, ry = rfy * ri, rz = rfz * ri;
      emit(slot, off(ptx, rx), off(pty, ry), off(ptz, rz), rx, ry, rz,
           omf * sig, omf, omf, omf);
    }
    ++slot;
  }
  const float msamples = r[R_MS];
  if (is_ind && diffuse_gate) {
    for (int k = 0; k < (LIT ? sc.n_indirect : min(sc.n_indirect, 1)); ++k) {
      if ((float)k < msamples) {
        const float r1 = draw(e.k1, e.k2, PURPOSE_INDIRECT_R1 + 2u * k) * 2.0f - 1.0f;
        const float phi = draw(e.k1, e.k2, PURPOSE_INDIRECT_R2 + 2u * k) * TWO_PI;
        const float sw = sub_<RN>(1.0f, mul_<RN>(r1, r1));
        float sin_p, cos_p;
        sincosf(phi, &sin_p, &cos_p);  // one range reduction, sinf's and cosf's bits
        float ddx = sw * cos_p, ddy = r1, ddz = sw * sin_p;
        if (!(dot_<RN>(ddx, ddy, ddz, nfx, nfy, nfz) >= 0.0f)) {
          ddx = -ddx;
          ddy = -ddy;
          ddz = -ddz;
        }
        const float fac = msamples * 0.5f;
        const float w = (nfx * ddx + nfy * ddy + nfz * ddz) / (fac > 0.0f ? fac : 1.0f);
        emit(slot + k, off(ptx, ddx), off(pty, ddy), off(ptz, ddz), ddx, ddy, ddz,
             sig, r[R_DIFF] * w, r[R_DIFF + 1] * w, r[R_DIFF + 2] * w);
      }
    }
  }
}

// the child entry a live slot spawns: throughput times the slot's weight,
// the stream derived from the slot
__device__ __forceinline__ Node child_node(const Node& e, int slot, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float sig, float wx,
                                           float wy, float wz) {
  Node c;
  c.ox = ox;
  c.oy = oy;
  c.oz = oz;
  c.dx = dx;
  c.dy = dy;
  c.dz = dz;
  c.sig = sig;
  c.tx = e.tx * wx;
  c.ty = e.ty * wy;
  c.tz = e.tz * wz;
  c.k1 = e.k1;
  c.k2 = e.k2;
  derive(c.k1, c.k2, (uint32_t)slot);
  c.live = true;
  return c;
}

// ---- a DFS stack entry: a Node's 13 words (ray 6, significance,
// throughput 3, two key words) and its depth, in a stack that gives word k
// of entry i as at(i, k) (megakernel_tree.cu's local stack; the slab)
constexpr int ENTRY_WORDS = 13;

// the stack in a slab of device memory: this thread's words `stride`
// apart, so that the threads of a warp at one depth of their stacks read
// one line together (K3's slab; the ring's lane state and stacks)
struct SlabStack {
  uint32_t* base;  // the slab plus the thread's index in the grid
  long long stride;  // the grid's threads
  __device__ __forceinline__ uint32_t& at(int i, int k) {
    return base[(long long)(i * ENTRY_WORDS + k) * stride];
  }
};

template <class Stack>
__device__ __forceinline__ void put(Stack& st, int i, const Node& e, int depth) {
  st.at(i, 0) = __float_as_uint(e.ox);
  st.at(i, 1) = __float_as_uint(e.oy);
  st.at(i, 2) = __float_as_uint(e.oz);
  st.at(i, 3) = __float_as_uint(e.dx);
  st.at(i, 4) = __float_as_uint(e.dy);
  st.at(i, 5) = __float_as_uint(e.dz);
  st.at(i, 6) = __float_as_uint(e.sig);
  st.at(i, 7) = __float_as_uint(e.tx);
  st.at(i, 8) = __float_as_uint(e.ty);
  st.at(i, 9) = __float_as_uint(e.tz);
  st.at(i, 10) = e.k1;
  st.at(i, 11) = e.k2;
  st.at(i, 12) = (uint32_t)depth;
}

template <class Stack>
__device__ __forceinline__ void get(Stack& st, int i, Node& e, int& depth) {
  e.ox = __uint_as_float(st.at(i, 0));
  e.oy = __uint_as_float(st.at(i, 1));
  e.oz = __uint_as_float(st.at(i, 2));
  e.dx = __uint_as_float(st.at(i, 3));
  e.dy = __uint_as_float(st.at(i, 4));
  e.dz = __uint_as_float(st.at(i, 5));
  e.sig = __uint_as_float(st.at(i, 6));
  e.tx = __uint_as_float(st.at(i, 7));
  e.ty = __uint_as_float(st.at(i, 8));
  e.tz = __uint_as_float(st.at(i, 9));
  e.k1 = st.at(i, 10);
  e.k2 = st.at(i, 11);
  e.live = true;
  depth = (int)st.at(i, 12);
}

// One node of the DFS (megakernel_tree.cu's walk; the ring's tree instance,
// one node a launch): shade e, its contribution into (cx, cy, cz), and its
// live children, of which the first becomes e at depth + 1 and the others
// are pushed onto the stack at sp in slot order and turned round, so that
// the lowest slot pops first; a node without a live child pops the next
// one.  Returns whether the walk goes on (false: the stack was empty).  A
// node's b child slots are routed to at most m children: slot j is child j
// when `direct` (b <= m), else the first m live slots in slot order.
template <bool SKY, class Ask, class Stack>
__device__ __forceinline__ bool dfs_node(const Scene& sc, const Ask& ask, Stack& stack, int& sp,
                                         Node& e, int& depth, int m, bool direct, float& cx,
                                         float& cy, float& cz) {
  Node next;
  int taken = 0;  // this node's live children so far
  const int sp0 = sp;
  shade_node<true, SKY>(sc, ask, e, depth, cx, cy, cz,
                        [&](int slot, float ox, float oy, float oz, float dx, float dy, float dz,
                            float sig, float wx, float wy, float wz) {
                          if (!direct && taken >= m) return;
                          const Node c =
                              child_node(e, slot, ox, oy, oz, dx, dy, dz, sig, wx, wy, wz);
                          if (taken++ == 0)
                            next = c;
                          else
                            put(stack, sp++, c, depth + 1);
                        });
  // the pushed children lie in slot order: turn them round, so that the
  // lowest slot pops first
  for (int i = sp0, j = sp - 1; i < j; ++i, --j) {
    for (int k = 0; k < ENTRY_WORDS; ++k) {
      const uint32_t t = stack.at(i, k);
      stack.at(i, k) = stack.at(j, k);
      stack.at(j, k) = t;
    }
  }
  if (taken > 0) {
    e = next;
    ++depth;
  } else if (sp > 0) {
    get(stack, --sp, e, depth);
  } else {
    return false;
  }
  return true;
}

// ---- what the runtime reports of a kernel, for the C entries rt_*_attrs:
// registers a thread, local memory a thread (bytes), static shared memory
// (bytes) and the most threads a block may have, into out[0..3].  Returns
// a cudaError_t.
template <class Kernel>
__host__ int func_attrs(Kernel kern, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}

}  // namespace rt
