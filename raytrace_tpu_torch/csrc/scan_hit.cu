// Scan closest hit for large scenes: (t, object id, hit) of N rays against
// the unified primitive table, one thread per ray.
//
// Replaces raytrace_tpu/ops/intersect_pallas.py::_kernel (the pallas_call
// of _scan_hit_fwd_kernel).  There a grid of ray blocks times 32-object
// chunks keeps the running minimum in a revisited output block; here a
// block stages the table once, a thread keeps its ray in registers, and the
// rays are answered by the fold the render kernels' large instances call
// (render_common.cuh, fold_closest): spheres (cx, cy, cz, r*r) then planes
// (n, p.n) in chunks of 32 rows, a sphere chunk skipped when the ray cannot
// enter its bounding sphere before its running best hit, ties to the lower
// object id.
//
// What bounds it on an H100: instruction throughput, some thirty float32
// instructions per sphere row and half as many per plane row that a ray
// must test; memory traffic is 24 B in and 9 B out per ray and the table
// once per block.  The fold's note in render_common.cuh says what the
// design does about it.  The table (20.5 B per row with ids and bounds)
// lies in shared memory when `fold_shared` says so, and is read through
// the read-only cache otherwise; where the 32 rays of a warp part and
// enter different chunks, the warp folds them one at a time with a table
// row per thread, so that they cost the sum of their own chunks and not 32
// times the union of them; a probe of the chunk bounds tells per warp.

#include "render_common.cuh"

namespace {

using namespace rt;

template <bool SH>
__global__ void __launch_bounds__(LARGE_THREADS)
scan_hit_kernel(const void* __restrict__ fold, int n_sph_chunks, int n_chunks,
                const float* __restrict__ rox, const float* __restrict__ roy,
                const float* __restrict__ roz, const float* __restrict__ rdx,
                const float* __restrict__ rdy, const float* __restrict__ rdz,
                float* __restrict__ t_out, int* __restrict__ gid_out,
                uint8_t* __restrict__ hit_out, long long n) {
  extern __shared__ float4 smem[];
  const void* fold_at = fold;
  if constexpr (SH) {
    stage_fold(fold, smem, n_chunks);
    __syncthreads();
    fold_at = smem;
  }
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Tables tb = make_tables(fold_at, n_sph_chunks, n_chunks);
  float t;
  int gid;
  const bool hit = fold_closest<SH>(tb, rox[lane], roy[lane], roz[lane], rdx[lane], rdy[lane],
                                    rdz[lane], t, gid);
  t_out[lane] = t;
  gid_out[lane] = gid;
  hit_out[lane] = hit ? 1 : 0;
}

template <bool SH>
int launch(const void* fold, int n_sph_chunks, int n_chunks, const float* rox,
           const float* roy, const float* roz, const float* rdx, const float* rdy,
           const float* rdz, float* t_out, int* gid_out, uint8_t* hit_out, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + LARGE_THREADS - 1) / LARGE_THREADS;
  const size_t smem = SH ? fold_bytes(n_chunks) : 0;
  cudaError_t err = cudaFuncSetAttribute(scan_hit_kernel<SH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_hit_kernel<SH><<<(unsigned)blocks, LARGE_THREADS, smem, stream>>>(
      fold, n_sph_chunks, n_chunks, rox, roy, roz, rdx, rdy, rdz, t_out, gid_out, hit_out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `fold` is the fold buffer of
// ops/intersect_scan.py::fold_buffer, 16-byte aligned: n_chunks * 32 rows
// of 4 floats, the first n_sph_chunks chunks spheres, then one int id per
// row, then 4 floats of bounds per chunk.  `fold_shared` stages it in
// shared memory (it must fit a block).  Writes n floats, n ints (2^31 - 1
// on a miss) and n bytes (0 or 1).  Returns the launch's cudaError_t.
int rt_scan_hit(const void* fold, int n_sph_chunks, int n_chunks, int fold_shared,
                const float* rox, const float* roy, const float* roz,
                const float* rdx, const float* rdy, const float* rdz, float* t_out,
                int* gid_out, uint8_t* hit_out, long long n, void* stream) {
  return (fold_shared ? launch<true> : launch<false>)(
      fold, n_sph_chunks, n_chunks, rox, roy, roz, rdx, rdy, rdz, t_out, gid_out, hit_out, n,
      (cudaStream_t)stream);
}

// What the runtime reports of the instance that stages the fold buffer in
// shared memory (`fold_shared` 1) or reads it from device memory (0), as
// render_common.cuh's func_attrs gives it: registers, local memory and
// static shared memory of a thread or block, the most threads of a block.
// ops/intersect_scan.py sizes the staged fold buffer from the registers of
// the instance that reads it from device memory.
int rt_scan_hit_attrs(int fold_shared, int* out) {
  return fold_shared ? func_attrs(scan_hit_kernel<true>, out)
                     : func_attrs(scan_hit_kernel<false>, out);
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
