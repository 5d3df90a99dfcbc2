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
// stream.  The placement path launches them at small shapes: (2, 512, 512)
// at most, and nearly always chunk refines of (1, 4..16, same), where a
// launch costs about what an empty one does.  What costs there is the
// chain from the launch to the first store; at the larger shapes, the
// arithmetic each store waits for and the blocks that fill the card.  So:
//
// * A block is 128 threads over a tile of TY * R rows and TX columns (TX
//   the power of two that covers k, at most 128; TY = 128 / TX), so a
//   narrow block still fills its threads.  A thread owns one column: it
//   loads that column's coordinates first, before anything waits, then
//   writes R rows of it; a warp's stores are consecutive columns of a row.
//   The grid is (column tiles, row tiles, B): no division to find a tile.
// * With R > 1 the tile's row coordinates are staged in shared memory by
//   coalesced loads behind one barrier and read as broadcasts.  With R = 1
//   (every chunk-refine shape) there is nothing to share: the row
//   coordinates go straight to registers, with no barrier and no second
//   round trip to memory.
// * R is the largest of 16, 8, 4, 2, 1 that leaves a block an SM (the SM
//   count is read once per device and cached), within kMaxTileRows rows a
//   tile.  A thread's row count is known before its row loop, so the
//   unrolled rows carry no exit test.
// * The torus sum is C - sum_d ||cu_d - cv_d| - dim_d/2| with C = sum_d
//   dim_d/2 (min(x, D - x) = D/2 - |x - D/2|): three adds a dimension.  The
//   fat-tree count is a select among 6, 4, 2, 0: three compares and no
//   conversion.  Both exact: every value is a small multiple of 1/2.
// * Stores are one value a thread, with the default cache policy: stores
//   of 16 bytes (2 or 4 columns a thread) were tried first and were slower
//   at every shape above the chunk refines' (PERF.md, section 6), and the
//   output is read at once by the `scale *` pass and the refine's
//   gathers, so it should stay in the 50 MB L2.
//
// Coordinates arrive as exact small integers in the compute dtype (float or
// double), so every hop value equals the plain PyTorch version's bit for
// bit.  The C entry points return cudaGetLastError() so the Python wrapper
// raises on a refused launch, including a grid past 65535 row tiles or
// candidates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "sm_count.cuh"

namespace {

constexpr int kBlock = 128;          // threads a block
constexpr int kLog2Block = 7;
constexpr int kRows = 16;            // most rows a thread (R)
constexpr int kMaxTileRows = 64;     // TY * R: the staging buffer's rows
constexpr int kMinBlocksPerSM = 1;   // R halves until the grid has these
constexpr int kRowUnroll = 4;        // rows a thread has in flight
constexpr int kMaxGridYZ = 65535;    // the grid's y and z limit

// One launch's output and tile width; the grid is (column tiles, row
// tiles, B).
struct Tiling {
  int m, k;       // output rows and columns
  int log2tx;     // TX = 1 << log2tx columns a tile
};

// min(|d|, dim - |d|) = dim/2 - ||d| - dim/2|, so the sum over the
// dimensions is C - sum ||d| - dim/2| with C = sum dim/2.
template <typename T, int ND>
struct Torus {
  T half[4];      // dim / 2
  T total;        // the sum of half[0 .. ND)
  __device__ __forceinline__ T operator()(const T* u, const T* v) const {
    T acc = total;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc -= fabs(fabs(u[d] - v[d]) - half[d]);
    return acc;
  }
};

template <typename T>
struct FatTree {
  // nested level matches, each subtracting 2 hops (same edge implies same
  // pod, same host implies same edge)
  __device__ __forceinline__ T operator()(const T* u, const T* v) const {
    const bool same_pod = u[0] == v[0];
    const bool same_edge = same_pod && u[1] == v[1];
    const bool same_host = same_edge && u[2] == v[2];
    return same_host ? T(0) : same_edge ? T(2) : same_pod ? T(4) : T(6);
  }
};

template <typename T, int R, int ND, class Metric>
__global__ void __launch_bounds__(kBlock)
hop_kernel(const T* __restrict__ cu, const T* __restrict__ cv,
           T* __restrict__ out, Tiling g, Metric f) {
  // the tile's row coordinates, TY * R rows of ND values (R > 1)
  __shared__ T srow[R > 1 ? kMaxTileRows * ND : 1];
  const int tx = threadIdx.x & ((1 << g.log2tx) - 1);
  const int ty = threadIdx.x >> g.log2tx;
  const int ty_n = kBlock >> g.log2tx;           // TY: rows a step
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = rt * ty_n * R;                  // the tile's first row
  const int c = (ct << g.log2tx) + tx;           // this thread's column
  T v[ND];
  if (c < g.k) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
      v[d] = cv[(static_cast<int64_t>(b) * g.k + c) * ND + d];
  }
  const T* rows = cu + (static_cast<int64_t>(b) * g.m + r0) * ND;
  if constexpr (R > 1) {
    const int staged = (g.m - r0 < ty_n * R ? g.m - r0 : ty_n * R) * ND;
    for (int i = threadIdx.x; i < staged; i += kBlock) srow[i] = rows[i];
    __syncthreads();
  }
  if (c >= g.k) return;
  // this thread's rows: ty, ty + TY, ... below R * TY and m - r0; a trip
  // count known before the loop, so that the unrolled rows carry no exit
  // test and their loads can run ahead of the stores
  const int mine = (g.m - r0 - ty + ty_n - 1) >> (kLog2Block - g.log2tx);
  const int n = mine < R ? mine : R;
  T* o = out + (static_cast<int64_t>(b) * g.m + r0) * g.k + c;
#pragma unroll (kRowUnroll)
  for (int i = 0; i < n; ++i) {
    // the row within the tile; TY is 1 wherever k >= 128, and saying so
    // lets the compiler walk the rows without a multiply (up to 6 % at
    // (2, 512, 512) float32)
    const int lr = ty_n == 1 ? i : ty + i * ty_n;
    T u[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d)
      u[d] = R > 1 ? srow[lr * ND + d] : rows[lr * ND + d];
    o[static_cast<int64_t>(lr) * g.k] = f(u, v);
  }
}

template <typename T, int ND, class Metric>
int launch(const void* cu, const void* cv, void* out, int64_t B, int64_t m,
           int64_t k, Metric f, void* stream) {
  if (B == 0 || m == 0 || k == 0) return 0;
  if (B < 0 || m < 0 || k < 0 || m > INT_MAX || k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2tx = 0;
  while (log2tx < kLog2Block && (int64_t{1} << log2tx) < k) ++log2tx;
  const int64_t ty = kBlock >> log2tx;
  const int64_t nct = (k + (int64_t{1} << log2tx) - 1) >> log2tx;
  const int64_t sms = sm_count();
  // rows a thread: the most that still leave a block an SM
  int R = kRows;
  while (R > 1 && ty * R > kMaxTileRows) R /= 2;
  int64_t nrt = 0;
  for (;; R /= 2) {
    nrt = (m + ty * R - 1) / (ty * R);
    if (R == 1 || B * nrt * nct >= kMinBlocksPerSM * sms) break;
  }
  if (nrt > kMaxGridYZ || B > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tiling g{static_cast<int>(m), static_cast<int>(k), log2tx};
  const T* a = static_cast<const T*>(cu);
  const T* c = static_cast<const T*>(cv);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nct), static_cast<unsigned>(nrt),
                  static_cast<unsigned>(B));
  switch (R) {
    case 16:
      hop_kernel<T, 16, ND><<<grid, kBlock, 0, s>>>(a, c, o, g, f);
      break;
    case 8:
      hop_kernel<T, 8, ND><<<grid, kBlock, 0, s>>>(a, c, o, g, f);
      break;
    case 4:
      hop_kernel<T, 4, ND><<<grid, kBlock, 0, s>>>(a, c, o, g, f);
      break;
    case 2:
      hop_kernel<T, 2, ND><<<grid, kBlock, 0, s>>>(a, c, o, g, f);
      break;
    default:
      hop_kernel<T, 1, ND><<<grid, kBlock, 0, s>>>(a, c, o, g, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ND>
int launch_torus(const void* cu, const void* cv, void* out, int64_t B,
                 int64_t m, int64_t k, const double (&dims)[4],
                 void* stream) {
  Torus<T, ND> f{};
  for (int d = 0; d < ND; ++d) {
    f.half[d] = T(dims[d] / 2);
    f.total += f.half[d];
  }
  return launch<T, ND>(cu, cv, out, B, m, k, f, stream);
}

template <typename T>
int launch_torus(const void* cu, const void* cv, void* out, int64_t B,
                 int64_t m, int64_t k, int nd, double d0, double d1,
                 double d2, double d3, void* stream) {
  const double dims[4] = {d0, d1, d2, d3};
  switch (nd) {
    case 1:
      return launch_torus<T, 1>(cu, cv, out, B, m, k, dims, stream);
    case 2:
      return launch_torus<T, 2>(cu, cv, out, B, m, k, dims, stream);
    case 3:
      return launch_torus<T, 3>(cu, cv, out, B, m, k, dims, stream);
    case 4:
      return launch_torus<T, 4>(cu, cv, out, B, m, k, dims, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch<float, 3>(cu, cv, out, B, m, k, FatTree<float>{}, stream);
}

int fattree_hop_f64(const void* cu, const void* cv, void* out, int64_t B,
                    int64_t m, int64_t k, void* stream) {
  return launch<double, 3>(cu, cv, out, B, m, k, FatTree<double>{}, stream);
}

}  // extern "C"
