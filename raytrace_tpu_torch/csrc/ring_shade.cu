// The render kernels' node body for the object-sharded ring: K1's chain and
// K3's depth-first walk, one node a launch, one thread per lane.
//
// Replaces raytrace_tpu/render/megakernel.py::_kernel (the pallas_call of
// _radiance_lanes_fwd_kernel) in its linear and fan-out regimes where the
// scene's objects are sharded over a ring of ranks
// (raytrace_tpu_torch/parallel/ring.py).  There no kernel holds the scene:
// the closest hit of a node's ray is a minimum over the shards that
// circulate (the scan kernel, scan_hit.cu, on each resident shard), and so
// is the answer to each shadow ray.  The JAX package compiles the ring's
// whole chunk loop into one program (raytrace_tpu/parallel/ring.py,
// _render_chunks_ring); here the loop of K1 and K3 is cut at the two
// questions that shade_node (render_common.cuh) asks, and the ring answers
// them between launches:
//
//   ring_start   each lane's primary ray (primary_ray, as K1 and K3 make it)
//                becomes its node, from ids of either width as they come;
//   ring_shadow  (lit scenes) shade_node up to the lights, under a policy
//                that writes each light's shadow ray (origin, direction,
//                squared range) into an (n_light, 7, N) query buffer;
//   ring_rows    one step of the rows' ring: each lane whose winner lies
//                in the resident shard of the object table takes its row,
//                a warp's 32 rows copied together as one piece of `out`;
//   ring_finish  shade_node with the ring's answers: the hit (t, hit) of
//                each lane, the winner's row gathered per lane in the
//                kernels' row layout (ROW floats, the large scenes' rows),
//                and one blocked bit per light and lane.  It adds the node's
//                contribution to the lane's sum (a miss takes the solid
//                background, or sky_lookup inline in the SKY instances, as
//                K1+sky does) and makes the next node: the live child in a
//                linear scene (child_node); in a fan-out scene dfs_node, as
//                K3's walk takes it (the first live child next, the others
//                pushed in slot order, a pop when none is live), so that the
//                sums come in the same order.
//
// A lane's state lives in device memory between launches, each word of it
// `n` apart (SlabStack, render_common.cuh: a warp's lanes read one line
// together): its node, 13 words (ray 6, significance, throughput 3, two key
// words, depth); its sum (3 floats); a live flag; for a fan-out scene its
// stack pointer and its DFS stack, in K3's slab layout with the lanes as
// the stride.  A lane whose walk has ended keeps a zero direction, which the
// scan kernel rejects at every chunk bound and plane row.
//
// What bounds these kernels on an H100: the memory traffic of the state,
// some 200 B a lane and round with the rows and the answers, against the
// scan kernel's folds over the shards between them.
//
// This file is compiled with -fmad=false (ops/_build.py, KERNEL_FLAGS), as
// megakernel_tree.cu is: every product and sum rounds as the plain
// version's does, so both instances equal their plain twin
// (render/ring_shade.py, ring_shade_reference) to the bit on the card.

#include "render_common.cuh"

namespace {

using namespace rt;

constexpr int RING_THREADS = 128;
// floats of a shadow query: origin 3, direction 3, squared range
constexpr int QUERY = 7;

// what the ring answered for one lane: the hit and the winner's row; the
// rows are a large scene's, and the hit record takes RN arithmetic (it is
// the plain version's, ops/intersect.py::large_scene_rec, as in the large
// instances of K1 and K3)
struct RingAnswers {
  static constexpr bool GLOBAL = true;
  float t;
  bool hit;
  const float* r;
  __device__ __forceinline__ bool closest(const Scene&, const Node&, float& t_best,
                                          int& best) const {
    t_best = t;
    best = 0;
    return hit;
  }
  __device__ __forceinline__ const float* row(const Scene&, int) const { return r; }
};

// the first pass: each light's shadow ray into the query buffer, and no
// shading after the lights
struct RingQueries : RingAnswers {
  static constexpr bool TO_LIGHTS = true;
  float* q;  // (n_light, QUERY, n)
  long long lane, n;
  __device__ __forceinline__ bool blocked(const Scene&, int li, float sx, float sy, float sz,
                                          float lx, float ly, float lz, float sq, bool) const {
    float* p = q + (long long)li * QUERY * n + lane;
    p[0] = sx;
    p[n] = sy;
    p[2 * n] = sz;
    p[3 * n] = lx;
    p[4 * n] = ly;
    p[5 * n] = lz;
    p[6 * n] = sq;
    return true;
  }
};

// the second pass: the blocked bits that the ring found
struct RingBits : RingAnswers {
  static constexpr bool TO_LIGHTS = false;
  const uint8_t* bits;  // (n_light, n)
  long long lane, n;
  __device__ __forceinline__ bool blocked(const Scene&, int li, float, float, float, float,
                                          float, float, float, bool) const {
    return bits[(long long)li * n + lane] != 0;
  }
};

__device__ __forceinline__ Scene ring_scene(const float* s, int n_light, int max_depth,
                                            int has_reflect, int has_refract, int n_indirect,
                                            const Sky& sky) {
  return Scene{s, 0, n_light, max_depth, has_reflect, has_refract, n_indirect, nullptr,
               Tables{}, sky};
}

// the ids are read as they come, 32-bit (Id = uint32_t) or 64-bit (Id =
// unsigned long long) words, and each keeps its low 32 bits, as the plain
// version's words do (ops/rng.py::as_words): the wrapper launches nothing
// but this kernel
template <class Id>
__global__ void __launch_bounds__(RING_THREADS)
ring_start_kernel(const Id* __restrict__ pix, const Id* __restrict__ piy,
                  const Id* __restrict__ aa, const Id* __restrict__ cam,
                  const float* __restrict__ scene, int dof, uint32_t seed,
                  uint32_t* __restrict__ node, float* __restrict__ acc, int* __restrict__ live,
                  int* __restrict__ sp, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Node e = primary_ray<true>(scene, (uint32_t)pix[lane], (uint32_t)piy[lane],
                                   (uint32_t)aa[lane], (uint32_t)cam[lane], seed, dof != 0);
  SlabStack nd{node + lane, n};
  put(nd, 0, e, 0);
  acc[lane] = 0.0f;
  acc[n + lane] = 0.0f;
  acc[2 * n + lane] = 0.0f;
  live[lane] = 1;
  sp[lane] = 0;
}

__global__ void __launch_bounds__(RING_THREADS)
ring_shadow_kernel(const float* __restrict__ scene, int n_light, int max_depth, int has_reflect,
                   int has_refract, int n_indirect, const uint32_t* __restrict__ node,
                   const int* __restrict__ live, const float* __restrict__ t,
                   const uint8_t* __restrict__ hit, const float* __restrict__ rows,
                   float* __restrict__ q, long long n) {
  extern __shared__ float4 smem[];
  float* s = (float*)smem;
  stage_scene(scene, s, 0, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  // a light that the node does not ask about keeps a zero query
  for (int li = 0; li < n_light; ++li)
    for (int j = 0; j < QUERY; ++j) q[((long long)li * QUERY + j) * n + lane] = 0.0f;
  if (!live[lane]) return;
  const Scene sc = ring_scene(s, n_light, max_depth, has_reflect, has_refract, n_indirect, Sky{});
  SlabStack nd{const_cast<uint32_t*>(node) + lane, n};
  Node e;
  int depth;
  get(nd, 0, e, depth);
  const RingQueries ask{{t[lane], hit[lane] != 0, rows + lane * ROW}, q, lane, n};
  float cx, cy, cz;
  shade_node<true, false>(sc, ask, e, depth, cx, cy, cz,
                          [](int, float, float, float, float, float, float, float, float, float,
                             float) {});
}

// TREE: K3's walk (m children at most a node), else K1's chain
template <bool TREE, bool SKY>
__global__ void __launch_bounds__(RING_THREADS)
ring_finish_kernel(const float* __restrict__ scene, Sky sky, int n_light, int max_depth,
                   int has_reflect, int has_refract, int n_indirect, int m,
                   uint32_t* __restrict__ node, float* __restrict__ acc, int* __restrict__ live,
                   int* __restrict__ sp, uint32_t* __restrict__ stack,
                   const float* __restrict__ t, const uint8_t* __restrict__ hit,
                   const float* __restrict__ rows, const uint8_t* __restrict__ bits,
                   long long n) {
  extern __shared__ float4 smem[];
  float* s = (float*)smem;
  stage_scene(scene, s, 0, n_light);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n || !live[lane]) return;
  const Scene sc = ring_scene(s, n_light, max_depth, has_reflect, has_refract, n_indirect, sky);
  SlabStack nd{node + lane, n};
  Node e;
  int depth;
  get(nd, 0, e, depth);
  const RingBits ask{{t[lane], hit[lane] != 0, rows + lane * ROW}, bits, lane, n};
  float cx, cy, cz;
  bool walking;
  if constexpr (TREE) {
    SlabStack st{stack + lane, n};
    int p = sp[lane];
    walking = dfs_node<SKY>(sc, ask, st, p, e, depth, m, sc.slots() <= m, cx, cy, cz);
    sp[lane] = p;
  } else {
    Node next;
    next.live = false;
    shade_node<true, SKY>(sc, ask, e, depth, cx, cy, cz,
                          [&](int slot, float ox, float oy, float oz, float dx, float dy,
                              float dz, float sig, float wx, float wy, float wz) {
                            next = child_node(e, slot, ox, oy, oz, dx, dy, dz, sig, wx, wy, wz);
                          });
    walking = next.live;
    if (walking) {
      e = next;
      ++depth;
    }
  }
  acc[lane] += cx;
  acc[n + lane] += cy;
  acc[2 * n + lane] += cz;
  if (walking) {
    put(nd, 0, e, depth);
  } else {
    live[lane] = 0;
    nd.at(0, 3) = 0u;
    nd.at(0, 4) = 0u;
    nd.at(0, 5) = 0u;
  }
}

// one step of the rows' ring: the lanes whose winner lies in the resident
// row shard, object ids [first, first + per), take its row.  A warp copies
// the rows of its 32 lanes together: they fill 32 * ROW / 4 = 192 float4s
// of `out` in one piece, and thread t copies pieces t, t + 32, ..., t +
// 160, piece f being lane f / 6's float4 number f % 6.  So each store of
// the warp writes 512 contiguous bytes, and six neighbouring threads read
// one row of the shard whole (the shard, some hundred KB, stays in L2 and
// is read through the read-only path).  A lane whose winner is not
// resident keeps its row.  Every warp of the grid is whole (blocks_for),
// so that all 32 threads take part in the shuffles.
__global__ void __launch_bounds__(RING_THREADS)
ring_rows_kernel(const float4* __restrict__ shard, int first, int per,
                 const int* __restrict__ obj, float4* __restrict__ out, long long n) {
  constexpr int PIECES = ROW / 4;
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long warp0 = lane - (threadIdx.x & 31);
  int local = -1;
  if (lane < n) {
    const long long l = (long long)obj[lane] - first;
    if (l >= 0 && l < per) local = (int)l;
  }
  if (!__any_sync(0xffffffffu, local >= 0)) return;
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int f = (int)(threadIdx.x & 31) + 32 * j;
    const int l = f / PIECES, c = f - l * PIECES;
    const int src = __shfl_sync(0xffffffffu, local, l);
    if (src >= 0) out[(warp0 + l) * PIECES + c] = __ldg(shard + (long long)src * PIECES + c);
  }
}

using FinishKernel = decltype(&ring_finish_kernel<false, false>);

FinishKernel finish_instance(bool tree, bool sky) {
  return tree ? (sky ? ring_finish_kernel<true, true> : ring_finish_kernel<true, false>)
              : (sky ? ring_finish_kernel<false, true> : ring_finish_kernel<false, false>);
}

unsigned blocks_for(long long n) { return (unsigned)((n + RING_THREADS - 1) / RING_THREADS); }

template <class Kernel>
cudaError_t set_shared(Kernel kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and allocates nothing; it returns the
// launch's cudaError_t.  The lane state: `node` (13, n) words, `acc` (3, n)
// floats, `live` and `sp` n ints, and for a fan-out scene `stack` (cap * 13,
// n) words, cap the plain walk's 1 + (max_depth + 1)(m - 1) entries
// (render/ring_shade.py::RingLanes).  `scene` is the scene buffer's header
// and lights (render/megakernel.py::pack_header) in device memory.

// The lanes' primary rays (pix, piy, aa, cam: n ids each, `id_bytes` 4
// for 32-bit ids, 8 for 64-bit ones, whose low 32 bits are the lane's
// words) into a fresh state; `dof` is 1 for the depth-of-field camera.
int rt_ring_start(const void* pix, const void* piy, const void* aa, const void* cam,
                  int id_bytes, const float* scene, int dof, uint32_t seed, uint32_t* node,
                  float* acc, int* live, int* sp, long long n, void* stream) {
  if (id_bytes != 4 && id_bytes != 8) return (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaSuccess;
  if (id_bytes == 4)
    ring_start_kernel<uint32_t><<<blocks_for(n), RING_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pix, (const uint32_t*)piy, (const uint32_t*)aa, (const uint32_t*)cam,
        scene, dof, seed, node, acc, live, sp, n);
  else
    ring_start_kernel<unsigned long long>
        <<<blocks_for(n), RING_THREADS, 0, (cudaStream_t)stream>>>(
            (const unsigned long long*)pix, (const unsigned long long*)piy,
            (const unsigned long long*)aa, (const unsigned long long*)cam, scene, dof, seed,
            node, acc, live, sp, n);
  return (int)cudaGetLastError();
}

// The shadow rays of the live lanes' nodes into `queries`, (n_light, 7, n)
// floats (origin, direction, squared range; zeros where the node asks
// nothing of a light), given the ring's closest hit of each node: `t` n
// floats, `hit` n bytes (0 or 1), `rows` (n, 24) floats, the winner's row
// (render/megakernel.py::kernel_rows).
int rt_ring_shadow(const float* scene, int n_light, int max_depth, int has_reflect,
                   int has_refract, int n_indirect, const uint32_t* node, const int* live,
                   const float* t, const uint8_t* hit, const float* rows, float* queries,
                   long long n, void* stream) {
  if (n < 1) return (int)cudaSuccess;
  const size_t smem = scene_bytes(0, n_light);
  cudaError_t err = set_shared(ring_shadow_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ring_shadow_kernel<<<blocks_for(n), RING_THREADS, smem, (cudaStream_t)stream>>>(
      scene, n_light, max_depth, has_reflect, has_refract, n_indirect, node, live, t, hit, rows,
      queries, n);
  return (int)cudaGetLastError();
}

// One round's shading of the live lanes, given the ring's answers (`t`,
// `hit`, `rows` as rt_ring_shadow takes them; `blocked` (n_light, n) bytes,
// null for a round without lights): each lane's contribution added to
// `acc`, its next node into `node`, `live` cleared where the walk ended.
// `m` > 0 selects the fan-out instances (m the most children of a node;
// `sp` and `stack` are read and written), 0 the linear ones.  A non-null
// `sky_quads` selects the skybox instances, with `sky_quads` and `face_hw`
// as rt_megakernel_linear takes them.
int rt_ring_finish(const float* scene, const float* sky_quads, const int* face_hw, int n_light,
                   int max_depth, int has_reflect, int has_refract, int n_indirect, int m,
                   uint32_t* node, float* acc, int* live, int* sp, uint32_t* stack,
                   const float* t, const uint8_t* hit, const float* rows, const uint8_t* blocked,
                   long long n, void* stream) {
  if (m < 0 || (m > 0 && (stack == nullptr || sp == nullptr))) return (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaSuccess;
  const FinishKernel kern = finish_instance(m > 0, sky_quads != nullptr);
  const size_t smem = scene_bytes(0, n_light);
  cudaError_t err = set_shared(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks_for(n), RING_THREADS, smem, (cudaStream_t)stream>>>(
      scene, make_sky(sky_quads, face_hw), n_light, max_depth, has_reflect, has_refract,
      n_indirect, m, node, acc, live, sp, stack, t, hit, rows, blocked, n);
  return (int)cudaGetLastError();
}

// One step of the rows' ring: the lanes whose winner `obj` (n ints) lies
// in the resident row shard `shard` ((per, 24) floats, the rows of object
// ids [first, first + per), 16-byte aligned) take its row into `out`
// ((n, 24) floats); the others keep theirs.  Every id of [0, objects)
// lies in one shard, so after the ring's k steps each lane has its row.
int rt_ring_rows(const float* shard, int first, int per, const int* obj, float* out,
                 long long n, void* stream) {
  if (n < 1) return (int)cudaSuccess;
  ring_rows_kernel<<<blocks_for(n), RING_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)shard, first, per, obj, (float4*)out, n);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
