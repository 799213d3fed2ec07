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
// What bounds it on an H100: the issue of its instructions, some thousands
// a lane (the object tests of every node, the shading, the RNG's integer
// hashes), and the latency that its warps in flight hide; memory traffic is
// 12 B out per lane, and in its ids: 16 B a lane from four lane arrays, or,
// in a render launch's factored form, 8 B a pixel and 4 a sample, which
// the pixel's lanes share (lane_id of render_common.cuh).  All ray state
// stays in registers for the whole chain, so registers decide the blocks an
// SM holds: the object loops stay rolled, each row carries the constant of its
// test (a sphere's r * r, a plane's p.n) so that no lane recomputes it, the
// two key hashes of a lane share their common prefix, one sincosf serves
// the indirect sample, and the launch bounds keep the lit instances at 72
// registers and the large ones at 64 (linear_min_blocks).  The scene
// (header, lights, one 24-float row per live object) is staged once per
// block into shared memory, where every thread of a warp reads the same
// address (a broadcast).  The closest-hit loop
// keeps only the running minimum and the winner's index; the winner's row
// is read once after the loop.  A lane leaves the chain as soon as it dies
// (miss or no live child), which is exact: a dead lane adds nothing to its
// radiance and never comes back to life.
//
// The large instances stage the header, the lights and, when it fits a
// block's shared memory, the scene's fold buffer (the unified primitive
// table with its ids and chunk bounds, 20.5 bytes per row: 83 KB at 4,006
// objects); a larger one is read from device memory through the read-only
// cache.  Closest hit and the shadow queries are the folds of
// render_common.cuh (fold_closest and fold_any), whose note says what bounds
// them and what their design does about it: a ray skips the sphere chunks
// whose bounding sphere it cannot enter before its running best hit, and a
// warp folds its rays one at a time with a row per thread, so that it pays
// for each ray's own chunks and not for the union of all 32.  These
// instances run 256 threads a block, so that two blocks, which is what an
// 83 KB table leaves room for on an SM, still keep 16 warps in flight.  The
// winner's 24-float row is one indexed load by object id.

#include "render_common.cuh"

namespace {

using namespace rt;

// The launch bounds: the blocks an SM must have room for, and so the
// registers a thread may take, of the small lean and sky instances, of the
// small lit ones (blocks of THREADS threads) and of the large lean and sky
// ones (blocks of LARGE_THREADS).  Held to 7 blocks, the small lit ones
// keep 72 registers, where they would take 76 and lose a block an SM; held
// to 4, the large ones keep 64, where they would take 69-72 and lose one
// (tools/torch_kernel_variants.py times these and others).
constexpr int LINEAR_MIN_BLOCKS = 1, LINEAR_LIT_MIN_BLOCKS = 7;
constexpr int LINEAR_LARGE_MIN_BLOCKS = 4;
constexpr int linear_min_blocks(bool lit, int large) {
  return large != 0 ? (lit ? 1 : LINEAR_LARGE_MIN_BLOCKS)
                    : (lit ? LINEAR_LIT_MIN_BLOCKS : LINEAR_MIN_BLOCKS);
}

// LARGE as SceneAnswers takes it: 0 a small scene, 1 and 2 a large one with
// its fold buffer in device memory or staged in shared memory
template <bool LIT, int LARGE, bool SKY>
__global__ void __launch_bounds__(LARGE != 0 ? LARGE_THREADS : THREADS,
                                  linear_min_blocks(LIT, LARGE))
megakernel_linear(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                  const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                  uint32_t samples, uint32_t lens, const float* __restrict__ scene,
                  const void* __restrict__ fold, int n_sph_chunks, int n_chunks, Sky sky,
                  int n_obj, int n_light, int max_depth, int has_reflect, int has_refract,
                  int n_indirect, int dof, uint32_t seed, float* __restrict__ out,
                  long long n) {
  extern __shared__ float4 smem[];
  float* s = (float*)smem;
  const void* fold_at = fold;
  if constexpr (LARGE == 2) {
    char* behind = (char*)smem + scene_bytes(0, n_light);
    stage_fold(fold, behind, n_chunks);
    fold_at = behind;
  }
  stage_scene(scene, s, LARGE != 0 ? 0 : n_obj, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the threads of this warp that have a lane (used by the large instances)
  const unsigned warp = LARGE != 0 ? __ballot_sync(0xFFFFFFFFu, lane < n) : 0u;
  if (lane >= n) return;
  const Scene sc{s, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect, scene,
                 make_tables(fold_at, n_sph_chunks, n_chunks), sky};

  const LaneId id = lane_id(Lanes{pix, piy, aa, cam, samples, lens}, lane);
  Node e = primary_ray<LARGE != 0>(s, id.px, id.py, id.aa, id.cam, seed, LIT && dof);
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  bool walking = true;
  for (int depth = 0; depth <= max_depth + 1; ++depth) {
    if constexpr (LARGE != 0) {
      // a large instance's threads start each round together, so that the
      // folds find all their peers; a thread whose chain has ended waits
      if (!__any_sync(warp, walking)) break;
      if (!walking) continue;
    }
    float cx, cy, cz;
    Node next;
    next.live = false;
    shade_node<LIT, SKY>(sc, SceneAnswers<LARGE>{}, e, depth, cx, cy, cz,
               [&](int slot, float ox, float oy, float oz, float dx, float dy, float dz,
                   float sig, float wx, float wy, float wz) {
                 next = child_node(e, slot, ox, oy, oz, dx, dy, dz, sig, wx, wy, wz);
               });
    accx += cx;
    accy += cy;
    accz += cz;
    if (!next.live) {
      if constexpr (LARGE != 0) {
        walking = false;
        continue;
      } else {
        break;
      }
    }
    e = next;
  }
  out[lane] = accx;
  out[n + lane] = accy;
  out[2 * n + lane] = accz;
}

template <bool LIT, int LARGE, bool SKY>
int launch(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa, const uint32_t* cam,
           uint32_t samples, uint32_t lens, const float* scene, const void* fold,
           int n_sph_chunks, int n_chunks, const Sky& sky, int n_obj, int n_light,
           int max_depth, int has_reflect, int has_refract, int n_indirect, int dof,
           uint32_t seed, float* out, long long n, cudaStream_t stream) {
  const int threads = LARGE != 0 ? LARGE_THREADS : THREADS;
  const long long blocks = (n + threads - 1) / threads;
  const size_t smem = scene_bytes(LARGE != 0 ? 0 : n_obj, n_light)
                      + (LARGE == 2 ? fold_bytes(n_chunks) : 0);
  cudaError_t err = cudaFuncSetAttribute(megakernel_linear<LIT, LARGE, SKY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  megakernel_linear<LIT, LARGE, SKY><<<(unsigned)blocks, threads, smem, stream>>>(
      pix, piy, aa, cam, samples, lens, scene, fold, n_sph_chunks, n_chunks, sky, n_obj,
      n_light, max_depth, has_reflect, has_refract, n_indirect, dof, seed, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z).  The lanes are n words in each of pix, piy, aa and
// cam where `lens` is 0, else a render launch in factored form (Lanes of
// render_common.cuh): n = P * samples * lens lanes of the P pixels of pix
// and piy, the `samples` sample ids of aa and `lens` lens samples, with cam
// unused.  Returns the launch's cudaError_t.  `dof` is 1
// for the depth-of-field camera.  Scenes with no light, no reflect or
// refract slot and a pinhole camera take the instance without their code.
// n_chunks > 0 selects the large instances: `fold` is then the scene's fold
// buffer (ops/intersect_scan.py::fold_buffer: n_chunks * 32 rows, the first
// n_sph_chunks chunks spheres, 16-byte aligned), staged in shared memory
// when `fold_shared` is set, and `scene` holds one row per object id.
// A non-null `sky_quads` selects the skybox instances: the faces packed for the
// lookup (models/backgrounds.py::pack_sky: (6, hmax, wmax, 16) float32, in
// device memory), with `face_hw` 14 ints in host memory (hmax, wmax, then
// each face's own height and width).
int rt_megakernel_linear(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                         const uint32_t* cam, uint32_t samples, uint32_t lens,
                         const float* scene, const void* fold,
                         int n_sph_chunks, int n_chunks, int fold_shared,
                         const float* sky_quads, const int* face_hw, int n_obj, int n_light,
                         int max_depth, int has_reflect, int has_refract, int n_indirect,
                         int dof, uint32_t seed, float* out, long long n, void* stream) {
  const bool lit = n_light > 0 || has_reflect || has_refract || dof;
  const Sky sky = make_sky(sky_quads, face_hw);
  const int large = n_chunks > 0 ? (fold_shared ? 2 : 1) : 0;
#define RT_PICK(LIT, SKY) \
  (large == 2 ? launch<LIT, 2, SKY> : large == 1 ? launch<LIT, 1, SKY> : launch<LIT, 0, SKY>)
  const auto fn = sky_quads != nullptr
                      ? (lit ? RT_PICK(true, true) : RT_PICK(false, true))
                      : (lit ? RT_PICK(true, false) : RT_PICK(false, false));
#undef RT_PICK
  return fn(pix, piy, aa, cam, samples, lens, scene, fold, n_sph_chunks, n_chunks, sky, n_obj,
            n_light, max_depth, has_reflect, has_refract, n_indirect, dof, seed, out, n,
            (cudaStream_t)stream);
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
