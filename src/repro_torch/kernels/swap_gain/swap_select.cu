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
// The unfused form (`swap_gain_tpu`) takes one (n, n) matrix pair and one
// mover and writes the whole (n,) gains row, unmasked.  It reads M and G
// once (2 n^2 values, two multiply-adds each), so bytes bound it: at
// n = 4096 from device memory; at n = 1024 (8 or 16 MB, which stay in the
// L2 between calls) from the L2, where what sets the time is the latency
// of the loads and how many are in flight.  Phase 1's map (one warp a
// column) left 128 blocks on 132 SMs at n = 1024, four scalar loads for two
// multiply-adds, and the mover's rows read again by every warp.  So
// swap_gain_tiles:
//
// * A block of kGainThreads threads owns a tile of R rows (columns c of the
//   gains row) and splits each row's length among its threads.  A thread
//   loads its share of the mover's rows M[i], G[i] once a step and uses it
//   for all R rows, so the mover's rows are read once a block.
// * Rows are read with 16-byte loads (float4 / double2) when n is a
//   multiple of 4 (f32) or 2 (f64) and M and G start on 16 bytes, which the
//   launcher reads from the pointers; otherwise the same walk with one
//   value a load (a contiguous view can start anywhere in its storage).
// * A step is U loads of each row (U * 2 (R + 1) <= kGainLoads, at least
//   one; one at R = 1), the rows' loads first since they need no mover
//   index; the next step's loads are sent before this step's
//   multiply-adds, and the scalar terms of the stored entry beside the
//   first step's, so no load waits behind the sums.
// * Both products go into one sum a row, reduced once: shuffles in each
//   warp, then the warps' partials through shared memory in a fixed order
//   (no atomics: the result does not depend on scheduling).
// * R is the largest of 8, 4, 2, 1 that still gives kGainMinBlocksPerSM
//   blocks an SM (the SM count is read once per device and cached): at
//   n = 1024 R = 2, 512 blocks; at n = 4096 R = 8.
//
// Every n takes the tiles.  The card test
// tests/test_torch_cuda.py::test_swap_gain_row_masked_is_swap_select holds
// the two forms together: the row, masked and reduced, equals
// swap_select's (gain, j) bit for bit on integer-valued inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm_count.cuh"

namespace {

constexpr int kWarps = 8;                 // columns per phase-1 block
constexpr int kThreads1 = kWarps * 32;
constexpr int kThreads2 = 256;            // phase-2 block
constexpr int kGainThreads = 128;         // threads of a gains-row block
constexpr int kGainMaxRows = 8;           // most rows a gains-row tile (R)
constexpr int kGainMinBlocksPerSM = 2;    // R halves until the grid has these
constexpr int kGainLoads = 16;            // loads a thread has in flight

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

// The type of one load of VW values.
template <typename T, int VW>
struct Vec {
  using type = T;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

__device__ __forceinline__ float dot_acc(float a, float b, float s) {
  return fmaf(a, b, s);
}
__device__ __forceinline__ double dot_acc(double a, double b, double s) {
  return fma(a, b, s);
}
__device__ __forceinline__ float dot_acc(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}
__device__ __forceinline__ double dot_acc(double2 a, double2 b, double s) {
  s = fma(a.x, b.x, s);
  return fma(a.y, b.y, s);
}

// One step of a thread's walk: U loads of each of its block's R rows of M
// and G and of the mover's rows, at vectors v0, v0 + kGainThreads, ...
// (none past nv); the rows first, as they need no mover index.
template <typename V, int U, int R>
struct Step {
  V m[U][R], g[U][R], mi[U], gi[U];

  __device__ __forceinline__ void fetch(const V* const* Mr,
                                        const V* const* Gr, const V* Mi,
                                        const V* Gi, int64_t v0,
                                        int64_t nv) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = v0 + static_cast<int64_t>(u) * kGainThreads;
      const bool in = v < nv;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        m[u][k] = in ? __ldg(Mr[k] + v) : V{};
        g[u][k] = in ? __ldg(Gr[k] + v) : V{};
      }
      mi[u] = in ? __ldg(Mi + v) : V{};
      gi[u] = in ? __ldg(Gi + v) : V{};
    }
  }

  template <typename T>
  __device__ __forceinline__ void add(T (&acc)[R]) const {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] = dot_acc(m[u][k], gi[u], acc[k]);   // (M @ G[i])[c]
        acc[k] = dot_acc(g[u][k], mi[u], acc[k]);   // (G @ M[i])[c]
      }
  }
};

// Unfused gains row in tiles: block x owns rows c0 = x * R .. c0 + R - 1
// and its threads split each row into loads of VW values; thread t takes
// loads t, t + kGainThreads, ... of every row, U at a time, the next
// step's loads sent before the current step's sums.
template <typename T, int VW, int R>
__global__ void __launch_bounds__(kGainThreads)
    swap_gain_tiles(const T* __restrict__ M, const T* __restrict__ G,
                   const T* __restrict__ contrib,
                   const int64_t* __restrict__ iv, T* __restrict__ out,
                   int64_t n) {
  using V = typename Vec<T, VW>::type;
  // one load of each row a step at R = 1 (n below 4 blocks an SM, 528 on
  // an H100): a thread's walk is a few loads there, and four a step cost
  // up to 0.2 us more at n 1 and 33 (PERF.md, section 6)
  constexpr int U = R == 1 ? 1
                    : kGainLoads / (2 * (R + 1)) > 0
                        ? kGainLoads / (2 * (R + 1)) : 1;
  constexpr int kW = kGainThreads / 32;
  __shared__ T part[kW][R];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t nv = n / VW;                 // loads a row
  const V* Mr[R];
  const V* Gr[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // rows of the last tile past n read row n - 1 again and store nothing
    const int64_t c = c0 + k < n ? c0 + k : n - 1;
    Mr[k] = reinterpret_cast<const V*>(M + c * n);
    Gr[k] = reinterpret_cast<const V*>(G + c * n);
  }
  const int64_t i = __ldg(iv);
  const V* Mi = reinterpret_cast<const V*>(M + i * n);
  const V* Gi = reinterpret_cast<const V*>(G + i * n);
  constexpr int64_t kStep = static_cast<int64_t>(U) * kGainThreads;
  Step<V, U, R> cur, next;
  cur.fetch(Mr, Gr, Mi, Gi, threadIdx.x, nv);
  // thread k < R stores row c0 + k: its scalar terms are loaded beside the
  // first step's loads, so the store waits on no load after the sums
  const int64_t c = c0 + threadIdx.x;
  const bool stores = threadIdx.x < R && c < n;
  T head = T(0);
  if (stores)
    head = contrib[i] + contrib[c] - T(2) * G[i * n + c] * M[i * n + c];
  T acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = T(0);
  for (int64_t v0 = threadIdx.x; v0 < nv; v0 += kStep) {
    next.fetch(Mr, Gr, Mi, Gi, v0 + kStep, nv);
    cur.add(acc);
    cur = next;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (stores) {
    const int k = threadIdx.x;
    T s = part[0][k];
#pragma unroll
    for (int w = 1; w < kW; ++w) s += part[w][k];
    out[c] = head - s;
  }
}

template <typename T, int VW>
void launch_tiles(int R, unsigned blocks, const T* M, const T* G,
                  const T* contrib, const int64_t* iv, T* out, int64_t n,
                  cudaStream_t s) {
  switch (R) {
    case 8:
      swap_gain_tiles<T, VW, 8><<<blocks, kGainThreads, 0, s>>>(
          M, G, contrib, iv, out, n);
      break;
    case 4:
      swap_gain_tiles<T, VW, 4><<<blocks, kGainThreads, 0, s>>>(
          M, G, contrib, iv, out, n);
      break;
    case 2:
      swap_gain_tiles<T, VW, 2><<<blocks, kGainThreads, 0, s>>>(
          M, G, contrib, iv, out, n);
      break;
    default:
      swap_gain_tiles<T, VW, 1><<<blocks, kGainThreads, 0, s>>>(
          M, G, contrib, iv, out, n);
  }
}

template <typename T>
int launch_gain(const void* M, const void* G, const void* contrib,
                const void* iv, void* out, int64_t n, void* stream) {
  if (n == 0) return 0;
  const T* m = static_cast<const T*>(M);
  const T* g = static_cast<const T*>(G);
  const T* c = static_cast<const T*>(contrib);
  const int64_t* i = static_cast<const int64_t*>(iv);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int VW = 16 / sizeof(T);
  // rows a tile: the most that still give kGainMinBlocksPerSM blocks an SM
  const int64_t sms = sm_count();
  int R = kGainMaxRows;
  while (R > 1 && (n + R - 1) / R < kGainMinBlocksPerSM * sms) R /= 2;
  const unsigned blocks = static_cast<unsigned>((n + R - 1) / R);
  const bool vec = n % VW == 0 && reinterpret_cast<uintptr_t>(M) % 16 == 0
                   && reinterpret_cast<uintptr_t>(G) % 16 == 0;
  if (vec)
    launch_tiles<T, VW>(R, blocks, m, g, c, i, o, n, s);
  else
    launch_tiles<T, 1>(R, blocks, m, g, c, i, o, n, s);
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
