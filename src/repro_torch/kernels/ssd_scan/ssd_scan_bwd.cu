// Mamba2 SSD chunked scan backward on Hopper, on the CUDA cores.
//
// The TPU kernel `ssd_scan_tpu` (src/repro/kernels/ssd_scan/kernel.py) has
// no backward: the reference trains through its plain `ssd_chunked` under
// `jax.grad`.  This is the gradient of the scan in ssd_scan.cu on the
// kernel's layout: xdt (B, H, S, P), dA (B, H, S) float32, B/C (B, G, S, N),
// head h reading group h / (H / G), state zero at the start, y (B, H, S, P)
// and the final state (B, H, P, N).  Given dy and, optionally, the final
// state's gradient gT, it writes dxdt, ddA, dB and dC.
//
// Per (b, h) and tile c of Q rows (Q = min(chunk, 64), the forward's
// tiles), with a_t the cumulative sum of dA within the tile, h the state
// entering the tile and g the gradient of the state leaving it:
//
//   dx_s  = sum_{t>=s} e^{a_t-a_s} (C_t.B_s) dy_t + e^{a_{Q-1}-a_s} g B_s
//   dB_s  = sum_{t>=s} e^{a_t-a_s} (dy_t.x_s) C_t + e^{a_{Q-1}-a_s} g^T x_s
//   dC_t  = sum_{s<=t} e^{a_t-a_s} (dy_t.x_s) B_s + e^{a_t} h^T dy_t
//   da_t  = sum_{s<=t} M_ts - sum_{s>=t} M_st + e^{a_t} dy_t.(h C_t) - w_t
//           (+ e^{a_{Q-1}} <g, h> + sum_s w_s at t = Q-1)
//   g_in  = e^{a_{Q-1}} g + sum_t e^{a_t} dy_t C_t^T
//
// with M_ts = e^{a_t-a_s} (C_t.B_s)(dy_t.x_s) and w_s = e^{a_{Q-1}-a_s}
// x_s.(g B_s); ddA is the reverse cumulative sum of da within the tile.
//
// Launches (after the wrapper recomputes the states entering each tile with
// the forward's own stages 1-2 in float32; they are not kept from the
// forward, 168 MB a layer at mamba2-2.7b's B 2 x 2048):
//
//   1. state gradients, grid (16-row slabs of P, H, B): a block walks the
//      tiles from the last to the first with its slab of g in registers,
//      writing the gradient of the state leaving each tile to the scratch
//      before folding in the tile (g_in above).  The walk is sequential
//      over tiles; the slabs, heads and batch rows run in parallel;
//   2. tile gradients, grid (tiles, H, B): a block stages its tile's x, dy,
//      B and C, forms C B^T and dy x^T, the masked, decayed W = L o C B^T
//      and V = L o dy x^T, and from them and the tile's g and h the four
//      gradients above.  dx and ddA (the in-tile reverse sum folded in)
//      are stored; dB and dC per head go to float32 scratch;
//   3. group sums: dB and dC of each group as the sum over its heads, in
//      head order, stored in the inputs' type.  No atomics anywhere, so two
//      runs give the same bits.
//
// Arithmetic: float32 everywhere (fmaf), whatever the input type;
// bfloat16 inputs are widened as they are staged and the gradients stored
// in their type (dA's gradient in float32).  Every product is a
// register-tiled outer product from shared memory: 256 threads in a 16 x 16
// grid, a thread holding rows ty + 16 u and columns tx + 16 v of an output,
// every staged matrix row-major with an odd row length, so a warp's 16
// column reads fall on 16 banks and its row reads are broadcasts.
//
// What bounds it: operations.  Per (b, group, tile) C B^T once, and per
// (b, h, tile) dy x^T and the six products dx, dB, dC, g B^T, x g and
// dy h (Q Q P or Q P N multiply-adds each), plus the state gradient and
// the forward's chunk states again (Q P N each).  Counted at the tile that
// needs the least (chip_smoke.py's `ssd_bwd_ops`), mamba2-2.7b's shape
// (B 2, H 80, G 1, S 2048, P 64, N 128) needs 28.7 GFLOP: 0.428 ms at the
// non-tensor float32 rate.  This design runs it at tiles of 64 on the
// CUDA cores: 3.54 ms on an H100 (12 % of that bound).
//
// Instances: P and N padded to (64, 64), (64, 128) or (128, 128) with zero
// rows and columns (zamba2, mamba2, the rest).  Shared memory of the tile
// kernel: 108 KB, 158 KB and 224 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kT = 64;         // rows of a tile, at most
constexpr int kMaxPN = 128;    // P and N
constexpr int kSlab = 16;      // rows of P a state-gradient block owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Shape {
  int H, G, S, P, N, Tq, nT;
};

// rows [0, rows) x columns [0, cols) of a row-major (., cols) matrix into
// dst[r][c] (kT rows of LD floats); the rest of the kT x (LD - 1) block is
// zero
template <int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int cols, int tid) {
  for (int e = tid; e < kT * (LD - 1); e += kThreads) {
    const int r = e / (LD - 1), c = e % (LD - 1);
    dst[r * LD + c] = r < rows && c < cols
                          ? to_f32(src[static_cast<int64_t>(r) * cols + c])
                          : 0.f;
  }
}

// cs[t] = dA[0] + ... + dA[t] over the tile's kT rows (dA 0 past `rows`),
// summed in row order by one thread; visible to the block on return
__device__ __forceinline__ void tile_cumsum(float* cs, const float* dA,
                                            int rows, int tid) {
  if (tid == 0) {
    float run = 0.f;
    for (int t = 0; t < kT; ++t) {
      if (t < rows) run += dA[t];
      cs[t] = run;
    }
  }
  __syncthreads();
}

// acc[u][v] += sum_{k < K} A(ty + 16 u, k) B(k, tx + 16 v), A(m, k) =
// a[m * am + k * ak], B(k, n) = b[k * bk + n * bn]
template <int TM, int TN>
__device__ __forceinline__ void gemm(float (&acc)[TM][TN], const float* a,
                                     int am, int ak, const float* b, int bk,
                                     int bn, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[TM], y[TN];
#pragma unroll
    for (int u = 0; u < TM; ++u) x[u] = a[(ty + 16 * u) * am + k * ak];
#pragma unroll
    for (int v = 0; v < TN; ++v) y[v] = b[k * bk + (tx + 16 * v) * bn];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(x[u], y[v], acc[u][v]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
}

// part[m][0..15] -> out[m] = sum over the 16 in order, for m < kT; the
// partials were written by the 16 threads of a row of the thread grid
__device__ __forceinline__ float sum16(const float* part, int m) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += part[m * 16 + k];
  return s;
}

// ----------------------------------------------- 1. state gradients
// gws[bh][c] (P x N, [p][n]) <- the gradient of the state leaving tile c
template <int KN, typename T>
__global__ void __launch_bounds__(kThreads)
    state_grad_kernel(const T* __restrict__ dy, const float* __restrict__ dA,
                      const T* __restrict__ Cm, const float* __restrict__ gT,
                      float* __restrict__ gws, Shape d) {
  constexpr int LDN = KN + 1, LDY = kSlab + 1, TN = KN / 16;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;              // kT x LDN: C rows t
  float* Ys = Cs + kT * LDN;     // kT x LDY: e^{a_t} dy[t][p0 + p]
  float* cs = Ys + kT * LDY;     // kT
  float* ex = cs + kT;           // kT

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * kSlab, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;
  const int p = p0 + ty;  // the thread's state row

  float g[TN];
#pragma unroll
  for (int v = 0; v < TN; ++v) {
    const int n = tx + 16 * v;
    g[v] = gT && p < d.P && n < d.N
               ? gT[(bh * d.P + p) * d.N + n]
               : 0.f;
  }
  for (int c = d.nT - 1; c >= 0; --c) {
    const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
    float* gb = gws + ((bh * d.nT + c) * d.P) * d.N;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int n = tx + 16 * v;
      if (p < d.P && n < d.N) gb[static_cast<int64_t>(p) * d.N + n] = g[v];
    }
    __syncthreads();  // the previous tile's operands are consumed
    tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
    if (tid < kT) ex[tid] = tid < rows ? expf(cs[tid]) : 0.f;
    __syncthreads();
    stage<LDN>(Cs, Cm + ((static_cast<int64_t>(b) * d.G + grp) * d.S + s0) *
                            d.N,
               rows, d.N, tid);
    // the slab's columns of dy, each row times e^{a_t}
    for (int e = tid; e < kT * kSlab; e += kThreads) {
      const int t = e / kSlab, q = e % kSlab;
      Ys[t * LDY + q] =
          t < rows && p0 + q < d.P
              ? ex[t] * to_f32(dy[(bh * d.S + s0 + t) * d.P + p0 + q])
              : 0.f;
    }
    __syncthreads();
    const float decay = expf(cs[kT - 1]);
#pragma unroll
    for (int v = 0; v < TN; ++v) g[v] *= decay;
    // g[p][n] += sum_t Ys[t][p] C[t][n]
#pragma unroll 4
    for (int t = 0; t < rows; ++t) {
      const float y = Ys[t * LDY + ty];
#pragma unroll
      for (int v = 0; v < TN; ++v)
        g[v] = fmaf(y, Cs[t * LDN + tx + 16 * v], g[v]);
    }
  }
}

// --------------------------------------------------- 2. tile gradients
template <int KP, int KN>
struct GradSmem {
  static constexpr int kLdN = KN + 1, kLdP = KP + 1, kLdQ = kT + 1;
  static constexpr size_t kFloats =
      2 * kT * kLdN + 2 * kT * kLdP + kT * kLdQ + KP * kLdN  // B C x dy W g|h
      + 5 * kT                                // cs, ex, dec, da, w
      + 2 * kT * 16 + kThreads;               // partial sums
};

template <int KP, int KN, typename T>
__global__ void __launch_bounds__(kThreads)
    tile_grad_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                     const T* __restrict__ Bm, const T* __restrict__ Cm,
                     const T* __restrict__ dy, const float* __restrict__ hws,
                     const float* __restrict__ gws, T* __restrict__ dx,
                     float* __restrict__ ddA, float* __restrict__ dBh,
                     float* __restrict__ dCh, Shape d) {
  using Sm = GradSmem<KP, KN>;
  constexpr int LDN = Sm::kLdN, LDP = Sm::kLdP, LDQ = Sm::kLdQ;
  constexpr int TP = KP / 16, TN = KN / 16, TQ = kT / 16;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;             // kT x LDN: B[s][n]
  float* Cs = Bs + kT * LDN;    // kT x LDN: C[t][n]
  float* Xs = Cs + kT * LDN;    // kT x LDP: x[s][p]
  float* Ys = Xs + kT * LDP;    // kT x LDP: dy[t][p]
  float* Wq = Ys + kT * LDP;    // kT x LDQ: W[t][s], then V[t][s]
  float* Ms = Wq + kT * LDQ;    // KP x LDN: g[p][n], then h[p][n]
  float* cs = Ms + KP * LDN;    // kT: a_t
  float* ex = cs + kT;          // kT: e^{a_t}
  float* dec = ex + kT;         // kT: e^{a_{Q-1} - a_t}
  float* da = dec + kT;         // kT
  float* wv = da + kT;          // kT: w_s
  float* part = wv + kT;        // kT x 16
  float* part2 = part + kT * 16;  // kT x 16
  float* red = part2 + kT * 16;   // kThreads

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;
  const int64_t bg = (static_cast<int64_t>(b) * d.G + grp) * d.S + s0;

  tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
  if (tid < kT) {
    ex[tid] = expf(cs[tid]);
    dec[tid] = expf(cs[kT - 1] - cs[tid]);
  }
  stage<LDN>(Bs, Bm + bg * d.N, rows, d.N, tid);
  stage<LDN>(Cs, Cm + bg * d.N, rows, d.N, tid);
  stage<LDP>(Xs, xdt + (bh * d.S + s0) * d.P, rows, d.P, tid);
  stage<LDP>(Ys, dy + (bh * d.S + s0) * d.P, rows, d.P, tid);
  __syncthreads();

  // CB[t][s] = C_t . B_s and DX[t][s] = dy_t . x_s, t = ty + 16 u,
  // s = tx + 16 v
  float cb[TQ][TQ], dxm[TQ][TQ];
  zero(cb);
  zero(dxm);
  gemm(cb, Cs, LDN, 1, Bs, 1, LDN, d.N, ty, tx);
  gemm(dxm, Ys, LDP, 1, Xs, 1, LDP, d.P, ty, tx);
  // W = L o CB to shared memory, V = L o DX kept, M = W o DX summed by row
  // (to da_t) and by column (from da_s)
  float vv[TQ][TQ];
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int t = ty + 16 * u;
    float rsum = 0.f;
#pragma unroll
    for (int v = 0; v < TQ; ++v) {
      const int s = tx + 16 * v;
      const float l = s <= t ? expf(cs[t] - cs[s]) : 0.f;
      const float w = l * cb[u][v];
      Wq[t * LDQ + s] = w;
      vv[u][v] = l * dxm[u][v];
      cb[u][v] = w * dxm[u][v];  // M
      rsum += cb[u][v];
    }
    part[t * 16 + tx] = rsum;
  }
#pragma unroll
  for (int v = 0; v < TQ; ++v) {
    float csum = 0.f;
#pragma unroll
    for (int u = 0; u < TQ; ++u) csum += cb[u][v];
    part2[(tx + 16 * v) * 16 + ty] = csum;
  }
  // g, the gradient of the state leaving this tile, as [p][n]
  {
    const float* gb = gws + (bh * d.nT + c) * d.P * d.N;
    for (int e = tid; e < KP * KN; e += kThreads) {
      const int p = e / KN, n = e % KN;
      Ms[p * LDN + n] = p < d.P && n < d.N ? gb[p * d.N + n] : 0.f;
    }
  }
  __syncthreads();
  if (tid < kT) da[tid] = sum16(part, tid) - sum16(part2, tid);
  __syncthreads();  // the partials are read before the next ones land

  // dx[s][p] = dec_s (B g^T)[s][p] + sum_t W[t][s] dy[t][p]; w_s = dec_s
  // x_s . (B g^T)_s
  {
    float acc[TQ][TP];
    zero(acc);
    gemm(acc, Bs, LDN, 1, Ms, 1, LDN, d.N, ty, tx);
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int s = ty + 16 * u;
      float ws = 0.f;
#pragma unroll
      for (int w = 0; w < TP; ++w) {
        acc[u][w] *= dec[s];
        ws = fmaf(Xs[s * LDP + tx + 16 * w], acc[u][w], ws);
      }
      part[s * 16 + tx] = ws;
    }
    gemm(acc, Wq, 1, LDQ, Ys, LDP, 1, kT, ty, tx);
    T* xb = dx + (bh * d.S + s0) * d.P;
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int s = ty + 16 * u;
      if (s >= rows) continue;
#pragma unroll
      for (int w = 0; w < TP; ++w) {
        const int p = tx + 16 * w;
        if (p < d.P) store(xb + static_cast<int64_t>(s) * d.P + p, acc[u][w]);
      }
    }
  }
  __syncthreads();  // W and the partials of w are complete
  if (tid < kT) wv[tid] = sum16(part, tid);
#pragma unroll
  for (int u = 0; u < TQ; ++u)
#pragma unroll
    for (int v = 0; v < TQ; ++v)
      Wq[(ty + 16 * u) * LDQ + tx + 16 * v] = vv[u][v];
  __syncthreads();

  // dB[s][n] = dec_s (x g)[s][n] + sum_t V[t][s] C[t][n]
  {
    float acc[TQ][TN];
    zero(acc);
    gemm(acc, Xs, LDP, 1, Ms, LDN, 1, d.P, ty, tx);
#pragma unroll
    for (int u = 0; u < TQ; ++u)
#pragma unroll
      for (int w = 0; w < TN; ++w) acc[u][w] *= dec[ty + 16 * u];
    gemm(acc, Wq, 1, LDQ, Cs, LDN, 1, kT, ty, tx);
    float* bb = dBh + (bh * d.S + s0) * d.N;
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int s = ty + 16 * u;
      if (s >= rows) continue;
#pragma unroll
      for (int w = 0; w < TN; ++w) {
        const int n = tx + 16 * w;
        if (n < d.N) bb[static_cast<int64_t>(s) * d.N + n] = acc[u][w];
      }
    }
  }
  __syncthreads();  // g is consumed but for <g, h>
  // h, the state entering this tile ([n][p] in the forward's workspace; zero
  // for the first tile), over g; <g, h> on the way
  {
    const float* hb = hws + (bh * d.nT + c) * d.N * d.P;
    float gh = 0.f;
    for (int e = tid; e < KP * KN; e += kThreads) {
      const int n = e / KP, p = e % KP;
      const float hv =
          c > 0 && p < d.P && n < d.N ? hb[n * d.P + p] : 0.f;
      gh = fmaf(Ms[p * LDN + n], hv, gh);
      Ms[p * LDN + n] = hv;
    }
    red[tid] = gh;
  }
  __syncthreads();

  // dC[t][n] = e^{a_t} (dy h)[t][n] + sum_s V[t][s] B[s][n]; the inter-tile
  // term of da_t is C_t . e^{a_t} (dy h)_t
  {
    float acc[TQ][TN];
    zero(acc);
    gemm(acc, Ys, LDP, 1, Ms, LDN, 1, d.P, ty, tx);
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int t = ty + 16 * u;
      float it = 0.f;
#pragma unroll
      for (int w = 0; w < TN; ++w) {
        acc[u][w] *= ex[t];
        it = fmaf(Cs[t * LDN + tx + 16 * w], acc[u][w], it);
      }
      part[t * 16 + tx] = it;
    }
    gemm(acc, Wq, LDQ, 1, Bs, LDN, 1, kT, ty, tx);
    float* cb2 = dCh + (bh * d.S + s0) * d.N;
#pragma unroll
    for (int u = 0; u < TQ; ++u) {
      const int t = ty + 16 * u;
      if (t >= rows) continue;
#pragma unroll
      for (int w = 0; w < TN; ++w) {
        const int n = tx + 16 * w;
        if (n < d.N) cb2[static_cast<int64_t>(t) * d.N + n] = acc[u][w];
      }
    }
  }
  __syncthreads();
  // da, then its reverse cumulative sum within the tile, in row order
  if (tid < kT) da[tid] += sum16(part, tid) - wv[tid];
  __syncthreads();
  if (tid == 0) {
    float gh = 0.f, wsum = 0.f;
    for (int k = 0; k < kThreads; ++k) gh += red[k];
    for (int s = 0; s < kT; ++s) wsum += wv[s];
    float run = ex[kT - 1] * gh + wsum;
    float* out = ddA + bh * d.S + s0;
    for (int t = kT - 1; t >= 0; --t) {
      run += da[t];
      if (t < rows) out[t] = run;
    }
  }
}

// ------------------------------------------------------ 3. group sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_sum_kernel(const float* __restrict__ dBh,
                     const float* __restrict__ dCh, T* __restrict__ dB,
                     T* __restrict__ dC, int64_t per_group, int rep,
                     int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  // e = (b G + g) per_group + rest; head k of the group at
  // ((b G + g) rep + k) per_group + rest
  const int64_t bg = e / per_group, rest = e % per_group;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < rep; ++k) {
    const int64_t i = (bg * rep + k) * per_group + rest;
    sb += dBh[i];
    sc += dCh[i];
  }
  store(dB + e, sb);
  store(dC + e, sc);
}

// ------------------------------------------------------------ launches
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int64_t tiles(int64_t S, int64_t chunk) {
  const int64_t tq = chunk < kT ? chunk : kT;
  return (S + tq - 1) / tq;
}

struct Args {
  const void *xdt, *dA, *Bm, *Cm, *dy, *gT, *hws;
  float* scratch;
  void *dx, *ddA, *dB, *dC;
  int B;
  Shape d;
  cudaStream_t stream;
};

template <int KP, int KN, typename T>
int run(const Args& a) {
  const Shape& d = a.d;
  const int64_t bhs = static_cast<int64_t>(a.B) * d.H;
  float* gws = a.scratch;
  float* dBh = gws + bhs * d.nT * d.P * d.N;
  float* dCh = dBh + bhs * d.S * d.N;
  const float* dA = static_cast<const float*>(a.dA);

  constexpr size_t s1 =
      sizeof(float) * (kT * (KN + 1) + kT * (kSlab + 1) + 2 * kT);
  int err = set_smem(state_grad_kernel<KN, T>, s1);
  if (err) return err;
  state_grad_kernel<KN, T><<<dim3((d.P + kSlab - 1) / kSlab, d.H, a.B),
                             kThreads, s1, a.stream>>>(
      static_cast<const T*>(a.dy), dA, static_cast<const T*>(a.Cm),
      static_cast<const float*>(a.gT), gws, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  constexpr size_t s2 = sizeof(float) * GradSmem<KP, KN>::kFloats;
  if ((err = set_smem(tile_grad_kernel<KP, KN, T>, s2))) return err;
  tile_grad_kernel<KP, KN, T><<<dim3(d.nT, d.H, a.B), kThreads, s2,
                                a.stream>>>(
      static_cast<const T*>(a.xdt), dA, static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.hws), gws, static_cast<T*>(a.dx),
      static_cast<float*>(a.ddA), dBh, dCh, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int64_t per_group = static_cast<int64_t>(d.S) * d.N;
  const int64_t n_out = static_cast<int64_t>(a.B) * d.G * per_group;
  group_sum_kernel<T><<<static_cast<unsigned>((n_out + kThreads - 1) /
                                              kThreads),
                        kThreads, 0, a.stream>>>(
      dBh, dCh, static_cast<T*>(a.dB), static_cast<T*>(a.dC), per_group,
      d.H / d.G, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_size(const Args& a) {
  const Shape& d = a.d;
  if (d.P <= 64 && d.N <= 64) return run<64, 64, T>(a);
  if (d.P <= 64) return run<64, 128, T>(a);
  return run<128, 128, T>(a);
}

int launch(bool is_bf16, const Args& base, int64_t B, int64_t H, int64_t G,
           int64_t S, int64_t P, int64_t N, int64_t chunk) {
  if (B == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || S <= 0 || S > INT32_MAX / kMaxPN ||
      chunk <= 0 || S % chunk != 0 || P <= 0 || P > kMaxPN || N <= 0 ||
      N > kMaxPN || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = base;
  a.B = static_cast<int>(B);
  a.d = Shape{static_cast<int>(H), static_cast<int>(G), static_cast<int>(S),
              static_cast<int>(P), static_cast<int>(N),
              static_cast<int>(chunk < kT ? chunk : kT),
              static_cast<int>(tiles(S, chunk))};
  return is_bf16 ? by_size<bf16>(a) : by_size<float>(a);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// float32 elements of the scratch the backward needs at this shape: the
// state gradients (B, H, tiles, P, N) and the per-head dB and dC
// (B, H, S, N) each
int64_t ssd_scan_bwd_scratch_floats(int64_t B, int64_t H, int64_t S,
                                    int64_t P, int64_t N, int64_t chunk) {
  if (chunk <= 0) return 0;
  return B * H * (tiles(S, chunk) * P * N + 2 * S * N);
}

// xdt, dy, dxdt (B, H, S, P) and B, C, dB, dC (B, G, S, N) in one type;
// dA, ddA (B, H, S) float32; gT null or (B, H, P, N) float32, the final
// state's gradient; hws the states entering each tile as the forward's
// stages 1-2 leave them in its workspace ((B, H, tiles, N, P) float32, at
// the same chunk); scratch ssd_scan_bwd_scratch_floats(...) floats.  All
// contiguous.  Three launches.
int ssd_scan_bwd_f32(const void* xdt, const void* dA, const void* Bm,
                     const void* Cm, const void* dy, const void* gT,
                     const void* hws, void* scratch, void* dxdt, void* ddA,
                     void* dB, void* dC, int64_t B, int64_t H, int64_t G,
                     int64_t S, int64_t P, int64_t N, int64_t chunk,
                     void* stream) {
  const Args a{xdt, dA, Bm, Cm, dy, gT, hws, static_cast<float*>(scratch),
               dxdt, ddA, dB, dC, 0, Shape{}, static_cast<cudaStream_t>(stream)};
  return launch(false, a, B, H, G, S, P, N, chunk);
}

int ssd_scan_bwd_bf16(const void* xdt, const void* dA, const void* Bm,
                      const void* Cm, const void* dy, const void* gT,
                      const void* hws, void* scratch, void* dxdt, void* ddA,
                      void* dB, void* dC, int64_t B, int64_t H, int64_t G,
                      int64_t S, int64_t P, int64_t N, int64_t chunk,
                      void* stream) {
  const Args a{xdt, dA, Bm, Cm, dy, gT, hws, static_cast<float*>(scratch),
               dxdt, ddA, dB, dC, 0, Shape{}, static_cast<cudaStream_t>(stream)};
  return launch(true, a, B, H, G, S, P, N, chunk);
}

}  // extern "C"
