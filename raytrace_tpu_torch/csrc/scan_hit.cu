// Scan closest hit for large scenes: (t, object id, hit) of N rays against
// the unified primitive table, one thread per ray.
//
// Replaces raytrace_tpu/ops/intersect_pallas.py::_kernel (the pallas_call
// of _scan_hit_fwd_kernel).  There a grid of ray blocks times 32-object
// chunks keeps the running minimum in a revisited output block; here a
// thread keeps its ray and its running (t, id) in registers and walks the
// table itself, which is the fold the render kernels' large instances call
// (render_common.cuh, fold_closest): spheres (cx, cy, cz, r) then planes
// (n, p.n) in chunks of 32 rows, a sphere chunk skipped when the ray cannot
// enter its bounding sphere before its running best hit, ties to the lower
// object id.
//
// What bounds it on an H100: FP32 issue, about 28 operations per sphere
// row and 14 per plane row that a ray must test; memory traffic is 24 B in
// and 9 B out per ray, and the table (16 B per row, read through the
// read-only cache, the same row for every thread of a warp) stays in L1
// and L2.  Incoherent rays of one warp enter different chunks, and the
// warp runs the union of them.

#include "render_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
scan_hit_kernel(Tables tb, const float* __restrict__ rox, const float* __restrict__ roy,
                const float* __restrict__ roz, const float* __restrict__ rdx,
                const float* __restrict__ rdy, const float* __restrict__ rdz,
                float* __restrict__ t_out, int* __restrict__ gid_out,
                uint8_t* __restrict__ hit_out, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t;
  int gid;
  const bool hit = fold_closest(tb, rox[lane], roy[lane], roz[lane], rdx[lane], rdy[lane],
                                rdz[lane], t, gid);
  t_out[lane] = t;
  gid_out[lane] = gid;
  hit_out[lane] = hit ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `table` holds n_chunks * 32
// rows of 4 floats, 16-byte aligned, the first n_sph_chunks chunks spheres;
// `ids` one int per row; `bounds` 4 floats per chunk.  Writes n floats, n
// ints (2^31 - 1 on a miss) and n bytes (0 or 1).  Returns the launch's
// cudaError_t.
int rt_scan_hit(const float* table, const int* ids, const float* bounds, int n_sph_chunks,
                int n_chunks, const float* rox, const float* roy, const float* roz,
                const float* rdx, const float* rdy, const float* rdz, float* t_out,
                int* gid_out, uint8_t* hit_out, long long n, void* stream) {
  const Tables tb{(const float4*)table, ids, (const float4*)bounds, n_sph_chunks, n_chunks};
  const long long blocks = (n + THREADS - 1) / THREADS;
  scan_hit_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      tb, rox, roy, roz, rdx, rdy, rdz, t_out, gid_out, hit_out, n);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
