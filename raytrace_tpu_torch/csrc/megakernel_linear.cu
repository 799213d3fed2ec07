// Megakernel for linear chains: the whole per-lane render pipeline in one
// CUDA kernel, one thread per lane.
//
// Replaces raytrace_tpu/render/megakernel.py::_kernel (the pallas_call of
// _radiance_lanes_fwd_kernel) in its small linear regime: at most 64 live
// objects, at most one child ray per shaded ray, float32, solid background,
// simple perspective camera, no lights, no mirror/Fresnel/Transparent
// materials.  Per lane it computes the RNG keys, the antialiasing jitter,
// the NDC transform and the camera ray (integrator.primary_rays), then up
// to max_depth + 2 rounds of closest-hit (intersect.closest_hit) and
// IndirectPhong shading (materials.shade) over a solid background
// (integrator.radiance_linear_v), and writes the summed radiance.
//
// What bounds it on an H100: FP32 issue and the special-function units
// (sqrt, rsqrt, division, sinf, cosf); memory traffic is 16 B in (four
// 32-bit lane ids) and 12 B out per lane.  All ray state stays in registers
// for the whole chain.  The scene (a header plus one 16-float row per live
// object, at most 4.2 KB) is staged once per block into shared memory,
// where every thread of a warp reads the same address (a broadcast).  The
// closest-hit loop keeps only the running minimum and the winner's index;
// the winner's row is read once after the loop.  A lane leaves the chain as
// soon as it dies (miss or no child), which is exact: a dead lane adds
// nothing to its radiance and never comes back to life.
//
// The arithmetic follows the plain PyTorch version
// (raytrace_tpu_torch/render/integrator.py::radiance_linear_v) operation
// by operation; the RNG words are bit-identical (uint32 wraparound), and
// floats may differ by the rounding of contracted multiply-adds.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// scene buffer layout; raytrace_tpu_torch/render/megakernel.py packs it
constexpr int HDR = 19;        // header floats
constexpr int H_CAM_POS = 0;   // 3
constexpr int H_CAM_M = 3;     // 9, row-major
constexpr int H_BG = 12;       // 3
constexpr int H_HALFW = 15;
constexpr int H_HALFH = 16;
constexpr int H_SCALE = 17;
constexpr int H_MIN_SIG = 18;
constexpr int ROW = 16;        // floats per object row
constexpr int R_P = 0;         // sphere center / plane point, 3
constexpr int R_Q = 3;         // sphere radius in [0] / plane normal, 3
constexpr int R_DIFF = 6;      // 3
constexpr int R_AMB = 9;       // 3
constexpr int R_MS = 12;       // MC samples as float
constexpr int R_SPH = 13;      // 1 = sphere, 0 = plane
constexpr int R_IND = 14;      // 1 = IndirectPhong

constexpr int THREADS = 128;

constexpr uint32_t GAMMA = 0x9E3779B9u;
constexpr uint32_t PURPOSE_AA_X = 0u;
constexpr uint32_t PURPOSE_AA_Y = 1u;
constexpr uint32_t PURPOSE_INDIRECT_R1 = 1u << 16;
constexpr uint32_t PURPOSE_INDIRECT_R2 = (1u << 16) + 1u;
constexpr float OFFSET = (float)1e-5;           // secondary-ray origin offset
constexpr float TWO_PI = (float)6.283185307179586;  // float(2 pi)

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// ops/rng.py::hash_words with a seed word s
template <int N>
__device__ __forceinline__ uint32_t hash_words(uint32_t s, const uint32_t (&w)[N]) {
  uint32_t h = s ^ 0x243F6A88u;
#pragma unroll
  for (int i = 0; i < N; ++i) h = mix32(h + w[i] + GAMMA * (2u * i + 1u));
  return mix32(h);
}

template <int N>
__device__ __forceinline__ void make_keys(uint32_t seed, const uint32_t (&w)[N],
                                          uint32_t& k1, uint32_t& k2) {
  k1 = hash_words(seed ^ 0x243F6A88u, w);
  k2 = hash_words(seed ^ 0x85A308D3u, w);
}

// ops/rng.py::draw, float32: 24 random bits scaled by 2**-24
__device__ __forceinline__ float draw(uint32_t k1, uint32_t k2, uint32_t purpose) {
  uint32_t bits = mix32(k1 ^ mix32(k2 + GAMMA * (purpose + 1u)));
  return (float)(int)(bits >> 8) * 5.9604644775390625e-8f;
}

__global__ void __launch_bounds__(THREADS)
megakernel_linear(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                  const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                  const float* __restrict__ scene, int n_obj, int levels,
                  uint32_t seed, float* __restrict__ out, long long n) {
  extern __shared__ float s[];
  const int n_scene = HDR + ROW * n_obj;
  for (int j = threadIdx.x; j < n_scene; j += blockDim.x) s[j] = scene[j];
  __syncthreads();

  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* rows = s + HDR;

  // ---- primary ray (integrator.primary_rays) ----
  const uint32_t px = pix[lane], py = piy[lane], a_id = aa[lane], c_id = cam[lane];
  uint32_t jk1, jk2;
  const uint32_t w3[3] = {px, py, a_id};
  make_keys(seed, w3, jk1, jk2);
  const float u = draw(jk1, jk2, PURPOSE_AA_X);
  const float v = draw(jk1, jk2, PURPOSE_AA_Y);
  const float pos_x = (((float)(int)px + u) - s[H_HALFW]) * s[H_SCALE];
  const float pos_y = (((float)(int)py + v) - s[H_HALFH]) * s[H_SCALE];
  uint32_t k1, k2;
  const uint32_t w4[4] = {px, py, a_id, c_id};
  make_keys(seed, w4, k1, k2);

  const float* m = s + H_CAM_M;
  float dx = m[0] * pos_x + m[1] * pos_y + m[2];
  float dy = m[3] * pos_x + m[4] * pos_y + m[5];
  float dz = m[6] * pos_x + m[7] * pos_y + m[8];
  const float dinv = rsqrtf(dx * dx + dy * dy + dz * dz);
  float rdx = dx * dinv, rdy = dy * dinv, rdz = dz * dinv;
  float rox = s[H_CAM_POS], roy = s[H_CAM_POS + 1], roz = s[H_CAM_POS + 2];

  // ---- the chain (integrator.radiance_linear_v) ----
  const float min_sig = s[H_MIN_SIG];
  const float sig = 1.0f;  // IndirectPhong children inherit it unattenuated
  float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  for (int depth = 0; depth < levels; ++depth) {
    // closest hit: running minimum, first minimum in scene order wins
    const float a = rdx * rdx + rdy * rdy + rdz * rdz;
    const float inv2a = 0.5f / (a > 0.0f ? a : 1.0f);
    float t_best = INFINITY;
    int best = 0;  // miss lanes read the first live object's row
    bool hit = false;
    for (int o = 0; o < n_obj; ++o) {
      const float* r = rows + o * ROW;
      float t;
      bool valid;
      if (r[R_SPH] > 0.5f) {
        const float ocx = rox - r[R_P], ocy = roy - r[R_P + 1], ocz = roz - r[R_P + 2];
        const float b = 2.0f * (rdx * ocx + rdy * ocy + rdz * ocz);
        const float rad = r[R_Q];
        const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad;
        const float disc = b * b - 4.0f * a * cc;
        const bool has = disc > 0.0f;
        const float sq = sqrtf(has ? disc : 1.0f);
        const float t1 = (-b - sq) * inv2a;
        const float t2 = (-b + sq) * inv2a;
        t = t1 > 0.0f ? t1 : t2;
        valid = has && t > 0.0f;
      } else {
        const float qx = r[R_Q], qy = r[R_Q + 1], qz = r[R_Q + 2];
        const float p_dot_n = r[R_P] * qx + r[R_P + 1] * qy + r[R_P + 2] * qz;
        const float denom = rdx * qx + rdy * qy + rdz * qz;
        const float numer = p_dot_n - (rox * qx + roy * qy + roz * qz);
        const bool ok = denom != 0.0f;
        t = numer / (ok ? denom : 1.0f);
        valid = ok && t > 0.0f;
      }
      const float ti = valid ? t : INFINITY;
      if (ti < t_best) {
        t_best = ti;
        best = o;
      }
      hit = hit || valid;
    }
    if (!hit) {  // background, then the lane is dead
      accx += tpx * s[H_BG];
      accy += tpy * s[H_BG + 1];
      accz += tpz * s[H_BG + 2];
      break;
    }
    const float* r = rows + best * ROW;  // the one load of the winner's row
    accx += tpx * r[R_AMB];
    accy += tpy * r[R_AMB + 1];
    accz += tpz * r[R_AMB + 2];
    if (depth == levels - 1) break;  // past max_depth: ambient only

    // hit record: point, normal, snap onto the surface
    float ptx = rox + rdx * t_best, pty = roy + rdy * t_best, ptz = roz + rdz * t_best;
    const float relx = ptx - r[R_P], rely = pty - r[R_P + 1], relz = ptz - r[R_P + 2];
    const float nrm2 = relx * relx + rely * rely + relz * relz;
    const float inv = rsqrtf(nrm2 > 0.0f ? nrm2 : 1.0f);
    float nx, ny, nz;
    if (r[R_SPH] > 0.5f) {
      nx = relx * inv;
      ny = rely * inv;
      nz = relz * inv;
      const float k = r[R_Q] * inv;
      ptx = (ptx - relx) + relx * k;
      pty = (pty - rely) + rely * k;
      ptz = (ptz - relz) + relz * k;
    } else {
      nx = r[R_Q];
      ny = r[R_Q + 1];
      nz = r[R_Q + 2];
      const float nn = nx * nx + ny * ny + nz * nz;
      const float dist = ((ptx * nx + pty * ny + ptz * nz)
                          - (r[R_P] * nx + r[R_P + 1] * ny + r[R_P + 2] * nz))
                         / (nn > 0.0f ? nn : 1.0f);
      const float sc = nn > 0.0f ? dist : 0.0f;
      ptx = ptx - nx * sc;
      pty = pty - ny * sc;
      ptz = ptz - nz * sc;
    }

    // shade: flip toward the viewer, gate, spawn the indirect child
    const float nd = nx * rdx + ny * rdy + nz * rdz;
    const float nfx = nd > 0.0f ? -nx : nx;
    const float nfy = nd > 0.0f ? -ny : ny;
    const float nfz = nd > 0.0f ? -nz : nz;
    const float diff_sig = r[R_DIFF] + r[R_DIFF + 1] + r[R_DIFF + 2];
    const float msamples = r[R_MS];
    const bool gate = r[R_IND] > 0.5f && diff_sig * sig > min_sig && 0.0f < msamples;
    if (!gate) break;
    const float r1 = draw(k1, k2, PURPOSE_INDIRECT_R1) * 2.0f - 1.0f;
    const float phi = draw(k1, k2, PURPOSE_INDIRECT_R2) * TWO_PI;
    const float sw = 1.0f - r1 * r1;
    float ddx = sw * cosf(phi), ddy = r1, ddz = sw * sinf(phi);
    if (!(ddx * nfx + ddy * nfy + ddz * nfz >= 0.0f)) {
      ddx = -ddx;
      ddy = -ddy;
      ddz = -ddz;
    }
    const float fac = msamples * 0.5f;
    const float w = (nfx * ddx + nfy * ddy + nfz * ddz) / (fac > 0.0f ? fac : 1.0f);
    tpx = tpx * (r[R_DIFF] * w);
    tpy = tpy * (r[R_DIFF + 1] * w);
    tpz = tpz * (r[R_DIFF + 2] * w);
    rox = ptx + ddx * OFFSET;
    roy = pty + ddy * OFFSET;
    roz = ptz + ddz * OFFSET;
    rdx = ddx;
    rdy = ddy;
    rdz = ddz;
    // ops/rng.py::derive, child slot 0
    k1 = mix32(k1 + GAMMA);
    k2 = mix32(k2 ^ 0xBB67AE85u);
  }
  out[lane] = accx;
  out[n + lane] = accy;
  out[2 * n + lane] = accz;
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z).  Returns the launch's cudaError_t.
int rt_megakernel_linear(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                         const uint32_t* cam, const float* scene, int n_obj, int levels,
                         uint32_t seed, float* out, long long n, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = sizeof(float) * (HDR + ROW * (size_t)n_obj);
  megakernel_linear<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      pix, piy, aa, cam, scene, n_obj, levels, seed, out, n);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
