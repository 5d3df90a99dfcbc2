// Row RMSNorm on Hopper.
//
// Replaces the Pallas TPU kernel `rmsnorm_tpu`
// (src/repro/kernels/rmsnorm/kernel.py, body `_rmsnorm_kernel`):
//
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w)  cast to T
//
// with every step in float32 and the cast at the end, as the TPU kernel
// does (the model's plain `layers.rmsnorm` casts the rsqrt to x's dtype
// first, so in bfloat16 the two agree within a tolerance, not exactly).
//
// What bounds it: bytes.  Each row is read once and written once, at three
// operations per element, far below the card's rate.  The design: one warp
// per row, eight rows per 256-thread block.  The warp reads its row with
// neighbouring lanes on neighbouring addresses, reduces the sum of squares
// with shuffles (every lane ends with the same sum), and makes a second
// pass that scales and stores.  The second pass re-reads the row, which the
// first left in L1 (a row of D = 576 float32 values is 2.3 KB), so device
// memory sees one read.  The TPU kernel's row blocks padded to a multiple
// of the block are not carried over: the last block masks its missing rows.
//
// Types: float32 and bfloat16 (x, w and out share the type).  The C entry
// points return cudaGetLastError() so the Python wrapper raises on a
// refused launch; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, int64_t rows, int64_t D, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * D;
  float ss = 0.f;
  for (int64_t c = lane; c < D; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  T* o = out + row * D;
  for (int64_t c = lane; c < D; c += 32)
    store(o + c, to_f32(xr[c]) * r * to_f32(w[c]));
}

template <typename T>
int launch(const void* x, const void* w, void* out, int64_t rows, int64_t D,
           float eps, void* stream) {
  if (rows == 0 || D == 0) return 0;
  rmsnorm_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (rows, D) and w (D,) -> out (rows, D), all contiguous, one type.
int rmsnorm_f32(const void* x, const void* w, void* out, int64_t rows,
                int64_t D, float eps, void* stream) {
  return launch<float>(x, w, out, rows, D, eps, stream);
}

int rmsnorm_bf16(const void* x, const void* w, void* out, int64_t rows,
                 int64_t D, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, D, eps, stream);
}

}  // extern "C"
