// Megakernel for fan-out scenes: a depth-first walk of each lane's tree of
// child rays in one CUDA kernel, one thread per lane.
//
// Replaces the fan-out regimes of raytrace_tpu/render/megakernel.py::_kernel
// (the pallas_call of _radiance_lanes_fwd_kernel): radiance_tree_v traced
// in the kernel for trees of at most 63 nodes, and _tree_loop_scratch for
// larger ones.  Both walk the same nodes with the same RNG streams; this
// kernel is one form, the preorder walk of
// raytrace_tpu_torch/render/integrator.py::radiance_tree_loop_v (its plain
// version), with the same running sum.  Scenes: float32, a solid
// background or a skybox (looked up where a node's ray misses, in place of
// the reference's per-node miss records and post-pass), any materials, lights and camera; at most 64 live objects in the small
// instances, any number in the large ones (the reference's "large x
// fan-out" regime: the table fold of raytrace_tpu/ops/intersect_inline.py
// in the DFS's node body), which answer closest hit and the shadow queries
// by the folds of render_common.cuh over the scene's tables in device
// memory, as the linear kernel's large instances do.  The stack, the
// schedule and the routing are the same in both.
//
// Per lane: the primary ray, then a loop that pops a stack entry, runs one
// node (closest hit, shading with shadow rays, render_common.cuh), adds
// its contribution, and at an interior node pushes its m virtual children,
// child j at sp + (m-1-j) so that they pop in order.  A node's b child
// slots are routed to the m virtual children as in
// integrator.tree_loop_node: slot j to child j when b <= m, else the j-th
// live slot to child j.  Every child's RNG stream is derived from its
// original slot.
//
// What bounds it on an H100: FP32 issue and the special-function units, as
// in the linear kernel, times up to sum_d m^d node visits; memory traffic
// is still 16 B in and 12 B out per lane.  The stack is a per-thread local
// array of CAP entries of 13 words (CAP = the next power of two at or
// above 1 + (levels-1)(m-1); 8 entries, 416 B, for m = 2 and levels = 6).
// The tree's shape is the same for every lane, so the stack pointer is
// uniform across a warp and local-memory accesses coalesce.  A dead entry
// is still popped (the pointer stays uniform) but skips its node: it would
// add exact zeros, and its children are pushed dead.
//
// This file is compiled with -fmad=false (ops/_build.py, KERNEL_FLAGS).  A
// lane of a wide tree visits hundreds of nodes (601 for 24 indirect samples
// at max_depth 1), and a child ray that leaves a sphere at a grazing angle
// hits that sphere again or not by the last bit of the sphere test; with
// contracted multiply-adds 1.7-2.1% of such a scene's lanes parted from the
// plain version by more than 1e-4.  Uncontracted, every product and sum
// rounds as the plain version's does and the lanes agree to the bit, for 7%
// of the showcase's time (2.50 -> 2.69 ms per 2,097,152 lanes on an H100).

#include "render_common.cuh"

namespace {

using namespace rt;

template <int CAP, bool LARGE, bool SKY>
__global__ void __launch_bounds__(THREADS)
megakernel_tree(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                const float* __restrict__ scene, Tables tb, Sky sky, int n_obj, int n_light,
                int max_depth, int has_reflect, int has_refract, int n_indirect, int dof, int m,
                uint32_t seed, float* __restrict__ out, long long n) {
  extern __shared__ float s[];
  stage_scene(scene, s, LARGE ? 0 : n_obj, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Scene sc{s, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect, scene, tb,
                 sky};
  const int levels = max_depth + 2;
  const bool direct = sc.slots() <= m;  // slot j is virtual child j

  Node stack[CAP];
  int depth_of[CAP];
  stack[0] = primary_ray<LARGE>(s, pix[lane], piy[lane], aa[lane], cam[lane], seed, dof);
  depth_of[0] = 0;
  int sp = 1;
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  while (sp > 0) {
    --sp;
    const Node e = stack[sp];
    const int depth = depth_of[sp];
    const bool interior = depth < levels - 1;
    if (interior) {
      for (int j = 0; j < m; ++j) {
        stack[sp + j].live = false;
        depth_of[sp + j] = depth + 1;
      }
    }
    if (e.live) {
      float cx, cy, cz;
      int routed = 0;
      shade_node<true, LARGE, SKY>(sc, e, depth, cx, cy, cz,
                 [&](int slot, float ox, float oy, float oz, float dx, float dy, float dz,
                     float sig, float wx, float wy, float wz) {
                   const int v = direct ? slot : routed++;
                   if (v < m)
                     stack[sp + (m - 1 - v)] =
                         child_node(e, slot, ox, oy, oz, dx, dy, dz, sig, wx, wy, wz);
                 });
      accx += cx;
      accy += cy;
      accz += cz;
    }
    if (interior) sp += m;
  }
  out[lane] = accx;
  out[n + lane] = accy;
  out[2 * n + lane] = accz;
}

template <int CAP, bool LARGE, bool SKY>
int launch(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa, const uint32_t* cam,
           const float* scene, const Tables& tb, const Sky& sky, int n_obj, int n_light, int max_depth,
           int has_reflect, int has_refract, int n_indirect, int dof, int m, uint32_t seed,
           float* out, long long n, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = scene_bytes(LARGE ? 0 : n_obj, n_light);
  cudaError_t err = cudaFuncSetAttribute(megakernel_tree<CAP, LARGE, SKY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  megakernel_tree<CAP, LARGE, SKY><<<(unsigned)blocks, THREADS, smem, stream>>>(
      pix, piy, aa, cam, scene, tb, sky, n_obj, n_light, max_depth, has_reflect, has_refract,
      n_indirect, dof, m, seed, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z).  `dof` is 1 for the depth-of-field camera, `m` the
// virtual children per node.  Returns the launch's cudaError_t, or
// cudaErrorInvalidValue when the stack 1 + (levels-1)(m-1) exceeds 64
// entries (render/megakernel.py, MAX_TREE_STACK).  n_chunks > 0 selects the
// large instances and a non-null `cube` the skybox instances, with `table`,
// `ids`, `bounds`, `scene`, `cube` and `face_hw` as rt_megakernel_linear
// takes them.
int rt_megakernel_tree(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                       const uint32_t* cam, const float* scene, const float* table,
                       const int* ids, const float* bounds, int n_sph_chunks, int n_chunks,
                       const float* cube, const int* face_hw, int n_obj, int n_light, int max_depth, int has_reflect, int has_refract,
                       int n_indirect, int dof, int m, uint32_t seed, float* out, long long n,
                       void* stream) {
  const int cap = 1 + (max_depth + 1) * (m - 1);
  const cudaStream_t st = (cudaStream_t)stream;
  const Tables tb{(const float4*)table, ids, (const float4*)bounds, n_sph_chunks, n_chunks};
  const Sky sky = make_sky(cube, face_hw);
#define RT_LAUNCH(C)                                                                        \
  return (cube != nullptr ? (n_chunks > 0 ? launch<C, true, true> : launch<C, false, true>) \
                          : (n_chunks > 0 ? launch<C, true, false>                          \
                                          : launch<C, false, false>))(                      \
      pix, piy, aa, cam, scene, tb, sky, n_obj, n_light, max_depth, has_reflect,            \
      has_refract, n_indirect, dof, m, seed, out, n, st)
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (cap <= 8) RT_LAUNCH(8);
  if (cap <= 16) RT_LAUNCH(16);
  if (cap <= 32) RT_LAUNCH(32);
  if (cap <= 64) RT_LAUNCH(64);
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
