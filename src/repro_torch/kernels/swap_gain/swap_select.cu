// Swap gains of the pairwise-swap refiner, on Hopper: the fused select
// step and the unfused gains row.
//
// Replaces the Pallas TPU kernels `swap_select_tpu` and `swap_gain_tpu`
// (src/repro/kernels/swap_gain/kernel.py).  For every candidate b of a
// batch and its mover i = iv[b] it evaluates the dense gains row
//
//   g[c] = contrib[b, i] + contrib[b, c] - 2 G[i, c] M[b, i, c]
//          - (M[b] @ G[i])[c] - (G @ M[b, i])[c]
//
// masks g[i] = 0 (the identity swap) and g[c] = -inf for c >= n_valid
// (padding), takes the first-occurrence argmax, and applies the accept
// rule: j = argmax when best > 1e-9 (compared in the compute dtype) and
// i < n_valid, else j = i.  Outputs gain[b] (the masked best) and j[b].
//
// What bounds it: bytes.  Each gains row reads the candidate's whole
// (n, n) distance matrix M[b] and the shared guest matrix G once, at two
// multiply-adds per element, so the kernel is a read stream of B*n*n
// values of M (G, n*n values, stays hot in the 50 MB L2 across the batch).
// The TPU kernel revisits one output block across a sequential grid to
// carry the running argmax; blocks on Hopper run in parallel and in no
// order, so the reduction here has two phases:
//
//   1. swap_select_partial: grid (ceil(n / 8), B), one warp per column c.
//      The warp reads row c of M[b] and row c of G with coalesced loads,
//      reduces both dot products with shuffles, and the block keeps its
//      best (value, column) among its 8 columns.
//   2. swap_select_final: one block per candidate reduces the partials
//      under the total order (value descending, column ascending) -- the
//      lowest column among equal maxima wins, exactly the first-occurrence
//      argmax of the reference -- and applies the accept rule.
//
// No float atomics are used, so the result does not depend on block
// scheduling.  The wrapper allocates the partial buffers; the kernel
// allocates nothing.
//
// swap_gain_row is the unfused form (`swap_gain_tpu`): one (n, n) matrix
// pair and one mover, the whole (n,) gains row written out, unmasked.  It
// is bound by the same one read of M and G (2 n^2 values) and uses phase
// 1's grid and its arithmetic, `gain_entry`, so the two cannot drift
// apart.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // columns per phase-1 block
constexpr int kThreads1 = kWarps * 32;
constexpr int kThreads2 = 256;            // phase-2 block

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (v, j) beats (best, best_j) under (value desc, index asc)
template <typename T>
__device__ __forceinline__ bool beats(T v, int64_t j, T best, int64_t best_j) {
  return v > best || (v == best && j < best_j);
}

// Gains row entry g[c] for mover i of one candidate (its M row block Mb and
// contrib row cb), reduced across the warp: every lane calls it with its
// own lane index and gets the same value (the butterfly adds the same
// pairs on every lane).
template <typename T>
__device__ __forceinline__ T gain_entry(const T* __restrict__ Mb,
                                        const T* __restrict__ G,
                                        const T* __restrict__ cb, int64_t i,
                                        int64_t c, int64_t n, int lane) {
  const T* Mi = Mb + i * n;
  const T* Gi = G + i * n;
  const T* Mc = Mb + c * n;
  const T* Gc = G + c * n;
  T a = T(0), bb = T(0);
  for (int64_t r = lane; r < n; r += 32) {
    a += Mc[r] * Gi[r];    // (M @ G[i])[c]
    bb += Gc[r] * Mi[r];   // (G @ M[i])[c]
  }
  a = warp_sum(a);
  bb = warp_sum(bb);
  return cb[i] + cb[c] - T(2) * Gi[c] * Mi[c] - a - bb;
}

template <typename T>
__global__ void swap_select_partial(const T* __restrict__ M,
                                    const T* __restrict__ G,
                                    const T* __restrict__ contrib,
                                    const int64_t* __restrict__ iv,
                                    const int32_t* __restrict__ n_valid_p,
                                    T* __restrict__ part_v,
                                    int64_t* __restrict__ part_j, int64_t n) {
  __shared__ T sv[kWarps];
  __shared__ int64_t sj[kWarps];
  const int64_t b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t i = iv[b];
  const int64_t n_valid = n_valid_p[0];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  T g = T(-INFINITY);
  if (c < n) {
    g = gain_entry(M + b * n * n, G, contrib + b * n, i, c, n, lane);
    if (c == i) g = T(0);
    if (c >= n_valid) g = T(-INFINITY);
  }
  if (lane == 0) {
    sv[warp] = g;
    sj[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T best = sv[0];
    int64_t best_j = sj[0];
    for (int w = 1; w < kWarps; ++w)
      if (beats(sv[w], sj[w], best, best_j)) {
        best = sv[w];
        best_j = sj[w];
      }
    part_v[b * gridDim.x + blockIdx.x] = best;
    part_j[b * gridDim.x + blockIdx.x] = best_j;
  }
}

template <typename T>
__global__ void swap_select_final(const T* __restrict__ part_v,
                                  const int64_t* __restrict__ part_j,
                                  const int64_t* __restrict__ iv,
                                  const int32_t* __restrict__ n_valid_p,
                                  T* __restrict__ gain,
                                  int64_t* __restrict__ jout, int64_t nblk) {
  __shared__ T sv[kThreads2];
  __shared__ int64_t sj[kThreads2];
  const int64_t b = blockIdx.x;
  T best = T(-INFINITY);
  int64_t best_j = INT64_MAX;
  for (int64_t t = threadIdx.x; t < nblk; t += kThreads2) {
    const T v = part_v[b * nblk + t];
    const int64_t j = part_j[b * nblk + t];
    if (beats(v, j, best, best_j)) {
      best = v;
      best_j = j;
    }
  }
  sv[threadIdx.x] = best;
  sj[threadIdx.x] = best_j;
  __syncthreads();
  // the order is total, so any reduction tree gives the same winner
  for (int s = kThreads2 / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s &&
        beats(sv[threadIdx.x + s], sj[threadIdx.x + s], sv[threadIdx.x],
              sj[threadIdx.x])) {
      sv[threadIdx.x] = sv[threadIdx.x + s];
      sj[threadIdx.x] = sj[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int64_t i = iv[b];
    const T eps = T(1e-9);               // GAIN_EPS in the compute dtype
    const bool ok = sv[0] > eps && i < static_cast<int64_t>(n_valid_p[0]);
    gain[b] = sv[0];
    jout[b] = ok ? sj[0] : i;
  }
}

// Unfused gains row: grid ceil(n / 8), one warp per column c.
template <typename T>
__global__ void swap_gain_row(const T* __restrict__ M,
                              const T* __restrict__ G,
                              const T* __restrict__ contrib,
                              const int64_t* __restrict__ iv,
                              T* __restrict__ out, int64_t n) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;
  const T g = gain_entry(M, G, contrib, iv[0], c, n, lane);
  if (lane == 0) out[c] = g;
}

template <typename T>
int launch_gain(const void* M, const void* G, const void* contrib,
                const void* iv, void* out, int64_t n, void* stream) {
  if (n == 0) return 0;
  swap_gain_row<T><<<static_cast<unsigned>((n + kWarps - 1) / kWarps),
                     kThreads1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(M), static_cast<const T*>(G),
      static_cast<const T*>(contrib), static_cast<const int64_t*>(iv),
      static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* M, const void* G, const void* contrib, const void* iv,
           const void* n_valid, void* part_v, void* part_j, void* gain,
           void* j, int64_t B, int64_t n, void* stream) {
  if (B == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nblk = (n + kWarps - 1) / kWarps;
  swap_select_partial<T><<<dim3(static_cast<unsigned>(nblk),
                                static_cast<unsigned>(B)),
                           kThreads1, 0, s>>>(
      static_cast<const T*>(M), static_cast<const T*>(G),
      static_cast<const T*>(contrib), static_cast<const int64_t*>(iv),
      static_cast<const int32_t*>(n_valid), static_cast<T*>(part_v),
      static_cast<int64_t*>(part_j), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  swap_select_final<T><<<static_cast<unsigned>(B), kThreads2, 0, s>>>(
      static_cast<const T*>(part_v), static_cast<const int64_t*>(part_j),
      static_cast<const int64_t*>(iv), static_cast<const int32_t*>(n_valid),
      static_cast<T*>(gain), static_cast<int64_t*>(j), nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of phase-1 partials per candidate: the wrapper sizes the
// (B, nblk) scratch buffers with it.
int64_t swap_select_blocks(int64_t n) { return (n + kWarps - 1) / kWarps; }

int swap_select_f32(const void* M, const void* G, const void* contrib,
                    const void* iv, const void* n_valid, void* part_v,
                    void* part_j, void* gain, void* j, int64_t B, int64_t n,
                    void* stream) {
  return launch<float>(M, G, contrib, iv, n_valid, part_v, part_j, gain, j,
                       B, n, stream);
}

int swap_select_f64(const void* M, const void* G, const void* contrib,
                    const void* iv, const void* n_valid, void* part_v,
                    void* part_j, void* gain, void* j, int64_t B, int64_t n,
                    void* stream) {
  return launch<double>(M, G, contrib, iv, n_valid, part_v, part_j, gain, j,
                        B, n, stream);
}

// Unfused gains row for mover iv[0] (a one-element int64 device tensor):
// M, G (n, n), contrib (n,) -> out (n,).
int swap_gain_f32(const void* M, const void* G, const void* contrib,
                  const void* iv, void* out, int64_t n, void* stream) {
  return launch_gain<float>(M, G, contrib, iv, out, n, stream);
}

int swap_gain_f64(const void* M, const void* G, const void* contrib,
                  const void* iv, void* out, int64_t n, void* stream) {
  return launch_gain<double>(M, G, contrib, iv, out, n, stream);
}

}  // extern "C"
