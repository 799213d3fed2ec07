// Skybox lookup: the background radiance of N ray directions, one thread
// per direction.
//
// Replaces the post-pass of the skybox regime of
// raytrace_tpu/render/megakernel.py (the call of background_color on the
// miss records that its pallas_call streams out).  The lookup itself is
// sky_lookup of render_common.cuh, the function the render kernels call
// where a ray misses; this kernel maps it over directions alone, so the
// card can hold it against the plain version (models/backgrounds.py::
// _skybox) without Monte-Carlo paths in the way.
//
// What bounds it on an H100: bytes.  A direction reads 12 B, writes 12 B
// and needs four texels of 12 B, against a few dozen operations.
// Neighbouring directions need not be neighbours on a face, and six faces
// of 1024 x 1024 do not fit the L2, so the texels come from device memory
// in sectors of 32 B.  The lookup reads the faces packed for it
// (render_common.cuh, Sky): the four texels of a lookup lie in one 64-byte
// aligned block, three 16-byte loads and two sectors, the least that two
// rows of a face can take.  Directions and colors are (N, 3) rows, read
// and written as three floats per thread, coalesced across the warp.

#include "render_common.cuh"

namespace {

using namespace rt;

__global__ void __launch_bounds__(THREADS)
skybox_kernel(Sky sky, const float* __restrict__ rd, float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r, g, b;
  sky_lookup(sky, rd[3 * i], rd[3 * i + 1], rd[3 * i + 2], r, g, b);
  out[3 * i] = r;
  out[3 * i + 1] = g;
  out[3 * i + 2] = b;
}

}  // namespace

extern "C" {

// Launches on `stream`; allocates nothing.  `sky_quads` holds the packed
// faces (models/backgrounds.py::pack_sky: (6, hmax, wmax, 16) float32) in
// device memory, `face_hw` 14 ints in host memory (hmax, wmax, then each
// face's own height and width), `rd` and `out` n rows of 3 floats.
// Returns the launch's cudaError_t.
int rt_skybox(const float* sky_quads, const int* face_hw, const float* rd, float* out,
              long long n, void* stream) {
  if (sky_quads == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + THREADS - 1) / THREADS;
  skybox_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      make_sky(sky_quads, face_hw), rd, out, n);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
