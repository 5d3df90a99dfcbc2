// Implicit hop distances on Hopper: all-pairs torus and fat-tree blocks.
//
// Replaces the Pallas TPU kernels `torus_hop_tpu` and `fattree_hop_tpu`
// (src/repro/kernels/hop_dist/kernel.py).  Both compute an (m, k) block of
// hop distances straight from two coordinate tables, batched over a leading
// candidate dimension B so one launch serves TOFA's whole candidate stack:
//
//   torus:    out[b, u, v] = sum_d min(|cu_d - cv_d|, dim_d - |cu_d - cv_d|)
//   fat-tree: out[b, u, v] = 6 - 2*same_pod - 2*same_edge - 2*same_host
//
// What bounds them: the output.  Each input coordinate is a few bytes per
// row or column while the output is m*k values, so the kernel is a store
// stream; the arithmetic (a handful of compares and adds per element) is
// far below the card's rate.  The design keeps the store stream coalesced:
// one thread owns one output column and walks a tile of rows, so a warp
// writes 32 neighbouring values of one output row per step.  The tile's
// row coordinates are staged once in shared memory and read as broadcasts;
// each thread holds its column's coordinates in registers.  The TPU
// kernel's 128-lane padding of k is a TPU artifact and is not carried over:
// ragged edges are masked here.
//
// Coordinates arrive as exact small integers in the compute dtype (float or
// double), so every hop value is exact and equal to the plain PyTorch
// version bit for bit.  The C entry points return cudaGetLastError() so
// the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // output columns per block (one per thread)
constexpr int kRows = 16;      // output rows per block

template <typename T, int ND>
__global__ void torus_hop_kernel(const T* __restrict__ cu,
                                 const T* __restrict__ cv,
                                 T* __restrict__ out, int64_t m, int64_t k,
                                 T d0, T d1, T d2, T d3) {
  __shared__ T su[kRows * ND];
  const int64_t b = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int t = threadIdx.x; t < kRows * ND; t += kThreads) {
    const int64_t r = row0 + t / ND;
    su[t] = r < m ? cu[(b * m + r) * ND + t % ND] : T(0);
  }
  __syncthreads();
  if (col >= k) return;
  const T dims[4] = {d0, d1, d2, d3};
  T v[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) v[d] = cv[(b * k + col) * ND + d];
  const int64_t rows = m - row0 < kRows ? m - row0 : kRows;
  T* o = out + (b * m + row0) * k + col;
  for (int r = 0; r < rows; ++r) {
    T total = T(0);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const T diff = fabs(su[r * ND + d] - v[d]);
      total += fmin(diff, dims[d] - diff);
    }
    o[r * k] = total;
  }
}

template <typename T>
__global__ void fattree_hop_kernel(const T* __restrict__ cu,
                                   const T* __restrict__ cv,
                                   T* __restrict__ out, int64_t m,
                                   int64_t k) {
  __shared__ T su[kRows * 3];
  const int64_t b = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kRows;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int t = threadIdx.x; t < kRows * 3; t += kThreads) {
    const int64_t r = row0 + t / 3;
    su[t] = r < m ? cu[(b * m + r) * 3 + t % 3] : T(-1);
  }
  __syncthreads();
  if (col >= k) return;
  const T* c = cv + (b * k + col) * 3;
  const T pod = c[0], edge = c[1], host = c[2];
  const int64_t rows = m - row0 < kRows ? m - row0 : kRows;
  T* o = out + (b * m + row0) * k + col;
  for (int r = 0; r < rows; ++r) {
    // nested level matches, each subtracting 2 hops (same edge implies
    // same pod, same host implies same edge)
    const bool same_pod = su[r * 3] == pod;
    const bool same_edge = same_pod && su[r * 3 + 1] == edge;
    const bool same_host = same_edge && su[r * 3 + 2] == host;
    o[r * k] = T(6) - T(2) * T(same_pod) - T(2) * T(same_edge) -
               T(2) * T(same_host);
  }
}

dim3 grid_for(int64_t B, int64_t m, int64_t k) {
  return dim3(static_cast<unsigned>((k + kThreads - 1) / kThreads),
              static_cast<unsigned>((m + kRows - 1) / kRows),
              static_cast<unsigned>(B));
}

template <typename T>
int launch_torus(const void* cu, const void* cv, void* out, int64_t B,
                 int64_t m, int64_t k, int nd, double d0, double d1,
                 double d2, double d3, void* stream) {
  if (B == 0 || m == 0 || k == 0) return 0;
  const dim3 grid = grid_for(B, m, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(cu);
  const T* b = static_cast<const T*>(cv);
  T* o = static_cast<T*>(out);
  switch (nd) {
    case 1:
      torus_hop_kernel<T, 1><<<grid, kThreads, 0, s>>>(a, b, o, m, k, T(d0),
                                                      T(d1), T(d2), T(d3));
      break;
    case 2:
      torus_hop_kernel<T, 2><<<grid, kThreads, 0, s>>>(a, b, o, m, k, T(d0),
                                                      T(d1), T(d2), T(d3));
      break;
    case 3:
      torus_hop_kernel<T, 3><<<grid, kThreads, 0, s>>>(a, b, o, m, k, T(d0),
                                                      T(d1), T(d2), T(d3));
      break;
    case 4:
      torus_hop_kernel<T, 4><<<grid, kThreads, 0, s>>>(a, b, o, m, k, T(d0),
                                                      T(d1), T(d2), T(d3));
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fattree(const void* cu, const void* cv, void* out, int64_t B,
                   int64_t m, int64_t k, void* stream) {
  if (B == 0 || m == 0 || k == 0) return 0;
  fattree_hop_kernel<T><<<grid_for(B, m, k), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cu), static_cast<const T*>(cv),
      static_cast<T*>(out), m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int torus_hop_f32(const void* cu, const void* cv, void* out, int64_t B,
                  int64_t m, int64_t k, int nd, double d0, double d1,
                  double d2, double d3, void* stream) {
  return launch_torus<float>(cu, cv, out, B, m, k, nd, d0, d1, d2, d3,
                             stream);
}

int torus_hop_f64(const void* cu, const void* cv, void* out, int64_t B,
                  int64_t m, int64_t k, int nd, double d0, double d1,
                  double d2, double d3, void* stream) {
  return launch_torus<double>(cu, cv, out, B, m, k, nd, d0, d1, d2, d3,
                              stream);
}

int fattree_hop_f32(const void* cu, const void* cv, void* out, int64_t B,
                    int64_t m, int64_t k, void* stream) {
  return launch_fattree<float>(cu, cv, out, B, m, k, stream);
}

int fattree_hop_f64(const void* cu, const void* cv, void* out, int64_t B,
                    int64_t m, int64_t k, void* stream) {
  return launch_fattree<double>(cu, cv, out, B, m, k, stream);
}

}  // extern "C"
