// Megakernel for linear chains: the whole per-lane render pipeline in one
// CUDA kernel, one thread per lane.
//
// Replaces raytrace_tpu/render/megakernel.py::_kernel (the pallas_call of
// _radiance_lanes_fwd_kernel) in its linear regimes: at most one child slot
// per shaded ray (one indirect sample, or the reflect slot of mirror-Phong
// scenes), float32, a solid background or a skybox (the instances with SKY
// look the cube up where a ray misses, in place of the reference's miss
// records and post-pass); at most 64 live objects in the small
// instances, any number in the large ones, which replace the in-kernel
// table fold of raytrace_tpu/ops/intersect_inline.py (inline_fold,
// inline_closest_hit, inline_occluded) under radiance_linear_loop_v.  Per
// lane it computes the RNG keys, the antialiasing jitter and the camera ray
// (integrator.primary_rays, both cameras), then up to max_depth + 2 rounds
// of closest hit (intersect.closest_hit) and shading (materials.shade:
// ambient, point/directional/area lights with shadow any-hit, Phong
// specular, Fresnel factor, the reflect or indirect child), and writes the
// summed radiance (integrator.radiance_linear_v).  The device code is in
// render_common.cuh, shared with the tree kernel.
//
// What bounds it on an H100: FP32 issue and the special-function units
// (sqrt, rsqrt, division, sinf, cosf, powf), plus one shadow loop over the
// objects per light per level; memory traffic is 16 B in (four 32-bit lane
// ids) and 12 B out per lane.  All ray state stays in registers for the
// whole chain.  The scene (header, lights, one 24-float row per live
// object) is staged once per block into shared memory, where every thread
// of a warp reads the same address (a broadcast).  The closest-hit loop
// keeps only the running minimum and the winner's index; the winner's row
// is read once after the loop.  A lane leaves the chain as soon as it dies
// (miss or no live child), which is exact: a dead lane adds nothing to its
// radiance and never comes back to life.
//
// The large instances stage only the header and the lights.  Closest hit
// and the shadow queries fold over the unified primitive table in device
// memory (render_common.cuh, fold_closest and fold_any): 16 bytes per row
// through the read-only cache, the same row for every thread of a warp, so
// the table (64 KB at 4,006 objects) stays in L1 and L2 and the bound is
// still FP32 issue, now times the rows each ray must test.  A thread skips
// the sphere chunks whose bounding sphere its ray cannot enter before its
// running best hit; a warp runs a chunk while any of its threads needs it.
// The winner's 24-float row is one indexed load by object id.

#include "render_common.cuh"

namespace {

using namespace rt;

template <bool LIT, bool LARGE, bool SKY>
__global__ void __launch_bounds__(THREADS)
megakernel_linear(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                  const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                  const float* __restrict__ scene, Tables tb, Sky sky, int n_obj, int n_light,
                  int max_depth, int has_reflect, int has_refract, int n_indirect, int dof,
                  uint32_t seed, float* __restrict__ out, long long n) {
  extern __shared__ float s[];
  stage_scene(scene, s, LARGE ? 0 : n_obj, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Scene sc{s, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect, scene, tb,
                 sky};

  Node e = primary_ray<LARGE>(s, pix[lane], piy[lane], aa[lane], cam[lane], seed, LIT && dof);
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  for (int depth = 0; depth <= max_depth + 1; ++depth) {
    float cx, cy, cz;
    Node next;
    next.live = false;
    shade_node<LIT, LARGE, SKY>(sc, e, depth, cx, cy, cz,
               [&](int slot, float ox, float oy, float oz, float dx, float dy, float dz,
                   float sig, float wx, float wy, float wz) {
                 next = child_node(e, slot, ox, oy, oz, dx, dy, dz, sig, wx, wy, wz);
               });
    accx += cx;
    accy += cy;
    accz += cz;
    if (!next.live) break;
    e = next;
  }
  out[lane] = accx;
  out[n + lane] = accy;
  out[2 * n + lane] = accz;
}

template <bool LIT, bool LARGE, bool SKY>
int launch(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa, const uint32_t* cam,
           const float* scene, const Tables& tb, const Sky& sky, int n_obj, int n_light, int max_depth,
           int has_reflect, int has_refract, int n_indirect, int dof, uint32_t seed, float* out,
           long long n, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = scene_bytes(LARGE ? 0 : n_obj, n_light);
  cudaError_t err = cudaFuncSetAttribute(megakernel_linear<LIT, LARGE, SKY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  megakernel_linear<LIT, LARGE, SKY><<<(unsigned)blocks, THREADS, smem, stream>>>(
      pix, piy, aa, cam, scene, tb, sky, n_obj, n_light, max_depth, has_reflect, has_refract,
      n_indirect, dof, seed, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z).  Returns the launch's cudaError_t.  `dof` is 1
// for the depth-of-field camera.  Scenes with no light, no reflect or
// refract slot and a pinhole camera take the instance without their code.
// n_chunks > 0 selects the large instances: `table`, `ids` and `bounds` are
// then the scene's unified table (n_chunks * 32 rows, the first
// n_sph_chunks chunks spheres), and `scene` holds one row per object id.
// A non-null `cube` selects the skybox instances: the (6, hmax, wmax, 3)
// float32 faces in device memory, with `face_hw` 14 ints in host memory
// (hmax, wmax, then each face's own height and width).
int rt_megakernel_linear(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                         const uint32_t* cam, const float* scene, const float* table,
                         const int* ids, const float* bounds, int n_sph_chunks, int n_chunks,
                         const float* cube, const int* face_hw, int n_obj, int n_light, int max_depth, int has_reflect,
                         int has_refract, int n_indirect, int dof, uint32_t seed, float* out,
                         long long n, void* stream) {
  const bool lit = n_light > 0 || has_reflect || has_refract || dof;
  const Tables tb{(const float4*)table, ids, (const float4*)bounds, n_sph_chunks, n_chunks};
  const Sky sky = make_sky(cube, face_hw);
  const bool large = n_chunks > 0;
  const auto fn =
      cube != nullptr
          ? (large ? (lit ? launch<true, true, true> : launch<false, true, true>)
                   : (lit ? launch<true, false, true> : launch<false, false, true>))
          : (large ? (lit ? launch<true, true, false> : launch<false, true, false>)
                   : (lit ? launch<true, false, false> : launch<false, false, false>));
  return fn(pix, piy, aa, cam, scene, tb, sky, n_obj, n_light, max_depth, has_reflect, has_refract,
            n_indirect, dof, seed, out, n, (cudaStream_t)stream);
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
