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
// the reference's per-node miss records and post-pass), any materials,
// lights and camera; at most 64 live objects in the small instances, any
// number in the large ones (the reference's "large x fan-out" regime: the
// table fold of raytrace_tpu/ops/intersect_inline.py in the DFS's node
// body), which answer closest hit and the shadow queries by the folds of
// render_common.cuh over the scene's tables, as the linear kernel's large
// instances do.  The walk is the same in all of them.
//
// Per lane: the primary ray, then a loop that runs one node (closest hit,
// shading with shadow rays, render_common.cuh), adds its contribution and
// takes its live children: the first stays in registers and is the next
// node, the others go onto the thread's stack, deepest the last of them,
// so that they pop in slot order.  When a node has no live child the
// thread pops, and its walk ends when its stack is empty.  A node's b child
// slots are routed to at most m children as in integrator.tree_loop_node:
// slot j is child j when b <= m, else the first m live slots in slot order.
// Every child's RNG stream is derived from its original slot.  The plain
// version visits every node of the full m-ary tree and adds exact zeros at
// the dead ones; leaving those out changes no bit of the sum, since the
// live nodes are still added in preorder.
//
// What bounds it on an H100: instruction throughput in the node body (FP32 and
// the special-function units, as in the linear kernel), times the largest
// number of live nodes among a warp's 32 lanes, since a warp runs until
// its last lane's stack is empty; memory traffic is 12 B out per lane and
// in its ids 16 B, or 8 B a pixel and 4 a sample in a render launch's
// factored form (lane_id of render_common.cuh).  On the showcase 3.9 of
// the 63 nodes of a lane's tree are live, and a walk that popped all 63
// spent its time on dead entries: 18 words of local-memory traffic per
// pop, and a node body whenever any lane of the warp was live at that
// position of the tree.  Here a dead subtree is never pushed, popped or
// initialised, the stack pointer is the thread's own, and a warp iterates
// over the live nodes of its busiest lane.  Threads of a warp sit at
// different depths of their trees; the node body's only depth-dependent
// branch is the ambient return at the last level.
//
// The stack holds entries of 13 words (ray 6, significance, throughput 3,
// two key words, depth) and never more than (levels - 1)(m - 1) of them,
// the node in registers not counted.  Up to 256 entries it lies in local
// memory, a per-thread array of CAP entries (CAP the power of two at or
// above 1 + (levels-1)(m-1), render/megakernel.py::tree_instance).  With
// only live entries on it the stack's traffic no longer counts: a stack laid
// thread-minor in shared memory was the slower on every scene timed
// (PERF.md) and is not built.
//
// Deeper stacks (a 129-sample IndirectPhong material at the fixed max_depth
// 4 needs 641 entries, 33 KB a thread) take the slab instance (CAP 0): the
// stack lies in a slab of device memory that the wrapper allocates, word k
// of entry i of thread t at slab[(i * 13 + k) * T + t] for the grid's T
// threads, as the runtime lays out local memory, and the grid strides over
// the lanes.  The runtime reserves a local array for every thread that can
// be resident on the card, so at 256 entries a launch holds 13.3 KB x 2,048
// x 132 = 3.6 GB of device memory until the process ends, and at 5,116
// entries (1,024 samples) it would hold 72 GB.  The slab is sized by the
// threads of the grid, which are those that can be resident (the
// occupancy of the instance) and no more, and never above the wrapper's
// budget: the grid then has fewer threads and each walks more lanes, a
// warp taking the next 32 from a counter whenever it comes free.
// Between 65 and 256 entries both forms work; the local ones ship there
// because the card found them 5-14% faster (chip_smoke.py's deep-tree
// phase runs such trees through both, in turns; PERF.md), presumably since
// a store to the slab goes through to L2 where a local one stays in L1.
//
// This file is compiled with -fmad=false (ops/_build.py, KERNEL_FLAGS).  A
// lane of a wide tree visits hundreds of nodes (601 for 24 indirect samples
// at max_depth 1), and a child ray that leaves a sphere at a grazing angle
// hits that sphere again or not by the last bit of the sphere test; with
// contracted multiply-adds 1.7-2.1% of such a scene's lanes parted from the
// plain version by more than 1e-4.  Uncontracted, every product and sum
// rounds as the plain version's does and the lanes agree to the bit.

#include "render_common.cuh"

namespace {

using namespace rt;

// the stack in local memory: CAP entries of this thread's own
template <int CAP>
struct LocalStack {
  uint32_t w[CAP][ENTRY_WORDS];
  __device__ __forceinline__ uint32_t& at(int i, int k) { return w[i][k]; }
};

// blocks per SM that the register allocation must leave room for.  The
// sparse walk is bound by latency more than by throughput, so warps in flight
// count for more than registers: 8 blocks of 128 threads hold the small
// instances with the 8-entry stack to 64 registers (left alone they took
// 86 and ran 13% slower on the showcase; at 80 registers, 5% slower), 4
// blocks of 256 the large ones to 64 (left alone 104-107 registers and 25%
// slower on the mixed field; at 80 registers, 10% slower).  The deeper
// stacks serve wide trees, most of whose nodes are live; those walks ran
// 10-12% slower at 64 registers than at 80, so they keep room for 6 blocks,
// as do the 128- and 256-entry instances and the slab (CAP 0), whose trees
// are wider still.
constexpr int TREE_MIN_BLOCKS = 8, TREE_LARGE_MIN_BLOCKS = 4;
constexpr int tree_min_blocks(int cap, int large) {
  return large != 0 ? TREE_LARGE_MIN_BLOCKS : (cap > 0 && cap <= 8) ? TREE_MIN_BLOCKS : 6;
}

// one lane's walk: its radiance into out (x, then y, then z).  `warp`
// holds the threads of this warp that walk a lane now: they stay in the
// loop until the last of them is done, so that each round's node bodies
// start together and the folds of a large scene find all their peers
template <int LARGE, bool SKY, class Stack>
__device__ __forceinline__ void walk_lane(const Scene& sc, const float* s, Stack& stack,
                                          unsigned warp, long long lane, const Lanes& ids,
                                          int dof, int m, uint32_t seed,
                                          float* __restrict__ out, long long n) {
  const bool direct = sc.slots() <= m;  // slot j is child j
  int sp = 0;
  const LaneId id = lane_id(ids, lane);
  Node e = primary_ray<LARGE != 0>(s, id.px, id.py, id.aa, id.cam, seed, dof);
  int depth = 0;
  float accx = 0.0f, accy = 0.0f, accz = 0.0f;
  bool walking = true;
  while (__any_sync(warp, walking)) {
    if (!walking) continue;
    float cx, cy, cz;
    walking = dfs_node<SKY>(sc, SceneAnswers<LARGE>{}, stack, sp, e, depth, m, direct, cx, cy,
                            cz);
    accx += cx;
    accy += cy;
    accz += cz;
  }
  out[lane] = accx;
  out[n + lane] = accy;
  out[2 * n + lane] = accz;
}

// CAP: the entries of the stack in local memory, or 0 for the slab (then
// every warp of the grid takes the next 32 lanes from the counter `next`
// until none is left, each thread's stack at slab + its index in the
// grid).  LARGE as SceneAnswers takes it.
template <int CAP, int LARGE, bool SKY>
__global__ void __launch_bounds__(LARGE != 0 ? LARGE_THREADS : THREADS,
                                  tree_min_blocks(CAP, LARGE))
megakernel_tree(const uint32_t* __restrict__ pix, const uint32_t* __restrict__ piy,
                const uint32_t* __restrict__ aa, const uint32_t* __restrict__ cam,
                uint32_t samples, uint32_t lens, const float* __restrict__ scene,
                const void* __restrict__ fold, int n_sph_chunks, int n_chunks, Sky sky,
                int n_obj, int n_light, int max_depth, int has_reflect, int has_refract,
                int n_indirect, int dof, int m,
                uint32_t* __restrict__ slab, unsigned long long* __restrict__ next,
                uint32_t seed, float* __restrict__ out, long long n) {
  extern __shared__ float4 smem[];
  float* s = (float*)smem;
  // shared memory: the scene's header and lights (and a small scene's
  // rows), then a large scene's fold buffer when it is staged
  char* behind = (char*)smem + scene_bytes(LARGE != 0 ? 0 : n_obj, n_light);
  const void* fold_at = fold;
  if constexpr (LARGE == 2) {
    stage_fold(fold, behind, n_chunks);
    fold_at = behind;
  }
  stage_scene(scene, s, LARGE != 0 ? 0 : n_obj, n_light);
  const Scene sc{s, n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect, scene,
                 make_tables(fold_at, n_sph_chunks, n_chunks), sky};
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Lanes ids{pix, piy, aa, cam, samples, lens};
  if constexpr (CAP > 0) {
    const unsigned warp = __ballot_sync(0xFFFFFFFFu, tid < n);
    if (tid >= n) return;
    LocalStack<CAP> stack;
    walk_lane<LARGE, SKY>(sc, s, stack, warp, tid, ids, dof, m, seed, out, n);
  } else {
    SlabStack stack{slab + tid, (long long)gridDim.x * blockDim.x};
    // lanes are taken as the warps come free: a lane's tree can hold
    // thousands of nodes or one, and a fixed share per warp leaves the
    // card waiting for the warps that drew the large ones
    const int lid = threadIdx.x & 31;
    while (true) {
      unsigned long long first = 0;
      if (lid == 0) first = atomicAdd(next, 32ULL);
      first = __shfl_sync(0xFFFFFFFFu, first, 0);
      if (first >= (unsigned long long)n) break;
      const long long lane = (long long)first + lid;
      const unsigned warp = __ballot_sync(0xFFFFFFFFu, lane < n);
      if (lane < n)
        walk_lane<LARGE, SKY>(sc, s, stack, warp, lane, ids, dof, m, seed, out, n);
    }
  }
}

// every instance has this signature
using TreeKernel = decltype(&megakernel_tree<8, 0, false>);

template <int CAP>
TreeKernel pick(int large, bool sky) {
  if (sky)
    return large == 2 ? megakernel_tree<CAP, 2, true>
                      : large == 1 ? megakernel_tree<CAP, 1, true> : megakernel_tree<CAP, 0, true>;
  return large == 2 ? megakernel_tree<CAP, 2, false>
                    : large == 1 ? megakernel_tree<CAP, 1, false> : megakernel_tree<CAP, 0, false>;
}

// the instance of `cap` stack entries in local memory (0: the slab), of
// a large scene's (1, 2: its fold buffer in device or shared memory) or
// a small one's (0), with or without the skybox; nullptr for another cap
TreeKernel instance(int cap, int large, bool sky) {
  switch (cap) {
    case 0: return pick<0>(large, sky);
    case 8: return pick<8>(large, sky);
    case 16: return pick<16>(large, sky);
    case 32: return pick<32>(large, sky);
    case 64: return pick<64>(large, sky);
    case 128: return pick<128>(large, sky);
    case 256: return pick<256>(large, sky);
    default: return nullptr;
  }
}

int block_threads(int large) { return large != 0 ? LARGE_THREADS : THREADS; }

// dynamic shared memory of a block, set as the kernel's limit
cudaError_t prepare(TreeKernel kern, int large, int n_obj, int n_light, int n_chunks,
                    size_t& smem) {
  smem = scene_bytes(large != 0 ? 0 : n_obj, n_light) + (large == 2 ? fold_bytes(n_chunks) : 0);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int large_mode(int n_chunks, int fold_shared) {
  return n_chunks > 0 ? (fold_shared ? 2 : 1) : 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `out` holds 3 * n floats
// (x, then y, then z), of the lanes that pix, piy, aa, cam, `samples`
// and `lens` give as rt_megakernel_linear takes them.  `dof` is 1 for the
// depth-of-field camera, `m` the most children of a node.  `stack_cap` is the entries of a thread's
// stack: with a null `slab`, the local-memory instance of that many
// (render/megakernel.py::tree_instance: 8, 16, 32, 64, 128 or 256); with a
// slab, the slab instance, the slab holding stack_cap * 13 words for each
// of `slab_threads` threads (rt_megakernel_tree_slab_threads), which the
// grid does not exceed, and `next` one 64-bit counter of lanes taken,
// which the launch sets to 0 on `stream` first.  Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for another `stack_cap` and for a
// stack that does not hold the plain walk's 1 + (max_depth + 1)(m - 1)
// entries (the kernel keeps one of them, the node it runs, in registers;
// the rule is tree_instance's).  n_chunks > 0 selects the large instances and a
// non-null `sky_quads` the skybox instances, with `fold`, `fold_shared`,
// `scene`, `sky_quads` and `face_hw` as rt_megakernel_linear takes them.
int rt_megakernel_tree(const uint32_t* pix, const uint32_t* piy, const uint32_t* aa,
                       const uint32_t* cam, uint32_t samples, uint32_t lens,
                       const float* scene, const void* fold, int n_sph_chunks, int n_chunks,
                       int fold_shared, const float* sky_quads, const int* face_hw,
                       int n_obj, int n_light, int max_depth, int has_reflect,
                       int has_refract, int n_indirect, int dof, int m,
                       int stack_cap, uint32_t* slab, long long slab_threads,
                       unsigned long long* next, uint32_t seed, float* out, long long n,
                       void* stream) {
  if (m < 1 || max_depth < -1 || 1 + (long long)(max_depth + 1) * (m - 1) > stack_cap)
    return (int)cudaErrorInvalidValue;
  const int large = large_mode(n_chunks, fold_shared);
  const TreeKernel kern = instance(slab != nullptr ? 0 : stack_cap, large, sky_quads != nullptr);
  const int threads = block_threads(large);
  long long blocks = (n + threads - 1) / threads;
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  if (slab != nullptr) {
    if (slab_threads < threads || next == nullptr) return (int)cudaErrorInvalidValue;
    blocks = blocks < slab_threads / threads ? blocks : slab_threads / threads;
  }
  size_t smem;
  cudaError_t err = prepare(kern, large, n_obj, n_light, n_chunks, smem);
  if (err == cudaSuccess && slab != nullptr)
    err = cudaMemsetAsync(next, 0, sizeof(*next), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      pix, piy, aa, cam, samples, lens, scene, fold, n_sph_chunks, n_chunks,
      make_sky(sky_quads, face_hw),
      n_obj, n_light, max_depth, has_reflect, has_refract, n_indirect, dof, m, slab, next, seed,
      out, n);
  return (int)cudaGetLastError();
}

// The threads of a slab launch of n lanes into *threads: those of the
// slab instance that the card holds resident at once (its occupancy at
// this scene's shared memory, on every SM), no more than the lanes need,
// and no more than `max_bytes` of slab at `stack_cap` entries of 52 bytes
// a thread allow; a whole number of blocks, at least one.  Returns a
// cudaError_t.
int rt_megakernel_tree_slab_threads(int n_obj, int n_light, int n_chunks, int fold_shared,
                                    int sky, int stack_cap, long long n, long long max_bytes,
                                    long long* threads) {
  const int large = large_mode(n_chunks, fold_shared);
  const TreeKernel kern = instance(0, large, sky != 0);
  const int tpb = block_threads(large);
  size_t smem;
  cudaError_t err = prepare(kern, large, n_obj, n_light, n_chunks, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, tpb, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || stack_cap < 1) return (int)cudaErrorInvalidConfiguration;
  long long t = (long long)per_sm * sms * tpb;
  const long long need = (n + tpb - 1) / tpb * tpb;
  const long long afford = max_bytes / (4LL * ENTRY_WORDS * stack_cap) / tpb * tpb;
  t = t < need ? t : need;
  t = t < afford ? t : afford;
  *threads = t > tpb ? t : tpb;
  return (int)cudaSuccess;
}

// What the runtime reports of an instance (rt_megakernel_tree's
// `stack_cap`, 0 the slab; `large` 0, 1 or 2; `sky` 0 or 1): registers a
// thread, local memory a thread, static shared memory, and the most
// threads a block may have, into out[0..3].  Returns a cudaError_t.
int rt_megakernel_tree_attrs(int stack_cap, int large, int sky, int* out) {
  const TreeKernel kern = instance(stack_cap, large, sky != 0);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return func_attrs(kern, out);
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
