// Megakernel for linear chains: the whole per-lane render pipeline in one
// CUDA kernel, one thread per lane.
//
// Replaces raytrace_tpu/render/megakernel.py::_kernel (the pallas_call of
// _radiance_lanes_fwd_kernel) in its small linear regime: at most 64 live
// objects, at most one child slot per shaded ray (one indirect sample, or
// the reflect slot of mirror-Phong scenes), float32, solid background.  Per
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

#include "render_common.cuh"

namespace {

using namespace rt;

template <bool LIT>
__global__ void __launch_bounds__(THREADS)
megakernel_linear(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                  const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                  const float* __restrict__ scene, int n_obj, int n_light, int max_depth,
                  int has_reflect, int has_refract, int n_indirect, int dof, uint32_t seed,
                  float* __restrict__ out, long long n) {
  extern __shared__ float s[];
  stage_scene(scene, s, n_obj, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Scene sc{s, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect};

  Node e = primary_ray(s, pix[lane], piy[lane], aa[lane], cam[lane], seed, LIT && dof);
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  for (int depth = 0; depth <= max_depth + 1; ++depth) {
    float cx, cy, cz;
    Node next;
    next.live = false;
    shade_node<LIT>(sc, e, depth, cx, cy, cz,
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

template <bool LIT>
int launch(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa, const uint32_t* cam,
           const float* scene, int n_obj, int n_light, int max_depth, int has_reflect,
           int has_refract, int n_indirect, int dof, uint32_t seed, float* out, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = scene_bytes(n_obj, n_light);
  cudaError_t err = cudaFuncSetAttribute(megakernel_linear<LIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  megakernel_linear<LIT><<<(unsigned)blocks, THREADS, smem, stream>>>(
      pix, piy, aa, cam, scene, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect,
      dof, seed, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z).  Returns the launch's cudaError_t.  `dof` is 1
// for the depth-of-field camera.  Scenes with no light, no reflect or
// refract slot and a pinhole camera take the instance without their code.
int rt_megakernel_linear(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                         const uint32_t* cam, const float* scene, int n_obj, int n_light,
                         int max_depth, int has_reflect, int has_refract, int n_indirect,
                         int dof, uint32_t seed, float* out, long long n, void* stream) {
  const bool lit = n_light > 0 || has_reflect || has_refract || dof;
  return (lit ? launch<true> : launch<false>)(pix, piy, aa, cam, scene, n_obj, n_light,
                                              max_depth, has_reflect, has_refract, n_indirect,
                                              dof, seed, out, n, (cudaStream_t)stream);
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
