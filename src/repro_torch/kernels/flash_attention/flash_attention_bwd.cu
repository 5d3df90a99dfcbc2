// Flash attention backward on Hopper, on the CUDA cores.
//
// The TPU kernel `flash_attention_tpu`
// (src/repro/kernels/flash_attention/kernel.py) has no backward: the
// reference trains through its plain version under `jax.grad`.  This is the
// gradient of the forward in flash_attention.cu,
//
//   o = softmax(q k^T / sqrt(Dh) + mask) v
//
// for q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), GQA head h reading KV head
// h / (H / Hkv), the causal mask end-aligned (key j visible to query i when
// j <= i + Sk - Sq), keys at j >= Sk masked.  With x = q k^T log2(e) /
// sqrt(Dh) the forward's log2-domain scores, the per-row log-sum-exp `lse`
// the forward saved (float32 (B, H, Sq), natural log) and e = exp2(x -
// lse log2(e)), P = e / l with l = sum_j e.  Given dO, three launches:
//
//   1. row pass, grid (query tile, head, B): over the row's visible keys,
//      l = sum_j e_j and D = sum_j e_j dP_j / l (dP = dO V^T), stored as
//      (1 / l, D).  D is the softmax backward's sum_j P_j dP_j, which
//      equals dO . o; formed from the backward's own P and dP it makes
//      sum_j dS_j vanish to rounding, as the plain version's autograd
//      does: from dO . o (the forward's rounded o) it left about 5e-7 of
//      the largest dQ in rows whose dQ is 0 (the first query sees one key),
//      2.4x the plain version's error.  Recomputing l also absorbs the
//      rounding of the saved lse (about 9, so up to 5e-7 of every P);
//   2. dK/dV, grid (KV tile, KV head, B): a block keeps its K and V tile in
//      shared memory and walks every query tile of every query head of its
//      KV head's group (the heads in order, then the tiles in order):
//        S = Q K^T,  P = e / l,  dP = dO V^T,
//        dS = P o (dP - D),  dV += P^T dO,  dK += dS^T Q / sqrt(Dh);
//      query tiles wholly above the causal diagonal are skipped.  The GQA
//      sum over a group's heads is this loop: no atomics, and two runs give
//      the same bits;
//   3. dQ, grid (query tile, head, B): a block keeps its Q and dO tile and
//      walks the KV tiles up to its causal diagonal: S, P, dP and dS as
//      above, then dQ += dS K / sqrt(Dh).
//
// Recomputing S and dP in 1, 2 and 3 costs four products more than a
// single pass with atomically summed dQ, and keeps the result bitwise
// repeatable, which the bit-for-bit resume of training needs.  The three
// kernels form S and dP with the same code and order, so their P agree
// bit for bit.
//
// Arithmetic: every product and sum in float32 on the CUDA cores (fmaf),
// whatever the input type; float32 or bfloat16 inputs are widened as they
// are staged into shared memory and the gradients are stored in the
// inputs' type.  dK and dV sum up
// to (H / Hkv) Sq products an element, dQ up to Sk: one float32 sum that
// long drifts several times further from the exact gradient than the
// plain version's blocked matrix products do, so each tile's products
// are summed in fresh registers and each tile's sum is then added to the
// total (64-term sums, then one add a tile).
//
// What bounds it: operations.  Five products of 2 Dh operations per visible
// (query, key) pair are the least the gradient needs (S, dP, dV, dK, dQ),
// 2.5x the forward's 4 Dh; at the card's non-tensor float32 rate of
// 67 TFLOP/s that is 1.44 ms for smollm-135m at B 2 x 4096 (9 heads of 64).
// This design runs nine products (S and dP three times) as register-tiled
// outer products from shared memory: 256 threads in a 16 x 16 grid, a
// thread holding a 4 x 4 tile of every 64 x 64 product, its rows 16 apart
// (row ty + 16 u, column tx + 16 v), so a warp's 16 column reads fall on
// 16 rows of a tile whose row length (Dh + 1 floats, odd) spreads them over
// 16 banks, and its row reads are broadcasts: 9.7 ms at that shape on an
// H100 (15 % of the bound).  Tensor cores (wgmma, with 3xTF32 for float32
// as the forward does) are later work.
//
// Tiles: 64 query rows and 64 keys up to Dh 128, 32 and 32 above it.
// Shared memory: dK/dV 100 KB at Dh 64, 166 KB at Dh 128, 107 KB at
// Dh 192, 140 KB at Dh 256; the row pass and dQ about 16 KB less.
//
// The entry points take q, k, v and dO contiguous in one type (float32 or
// bfloat16), lse float32, a float32 scratch of 2 B H Sq floats for the row
// statistics, and
// write dq, dk, dv contiguous in the inputs' type.  They return the CUDA
// error code of the first launch that fails, so the Python wrapper raises;
// the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // a 16 x 16 thread grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Tiles {
  static constexpr int kBQ = D <= 128 ? 64 : 32;  // query rows a tile
  static constexpr int kBK = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr int kLd = D + 1;               // row of a Dh-wide tile
  static constexpr int kLdS = kBK + 1;            // row of a P or dS tile
  // dK/dV: K, V, Q, dO tiles, P and dS, lse log2(e), 1 / l and D of the
  // query rows
  static constexpr size_t kKvBytes =
      sizeof(float) * (static_cast<size_t>(2 * kBK + 2 * kBQ) * kLd +
                       2 * kBQ * kLdS + 3 * kBQ);
  // dQ: Q, dO, K, V tiles, dS and the row terms
  static constexpr size_t kQBytes =
      sizeof(float) * (static_cast<size_t>(2 * kBK + 2 * kBQ) * kLd +
                       kBQ * kLdS + 3 * kBQ);
  // the row pass: Q, dO, K, V tiles, lse log2(e) and two 16-way partials
  static constexpr size_t kRowBytes =
      sizeof(float) * (static_cast<size_t>(2 * kBK + 2 * kBQ) * kLd +
                       kBQ + 2 * kBQ * 16);
};

// rows [row0, row0 + ROWS) of a row-major (rows, D) matrix into dst[r][c]
// with rows of D + 1 floats; rows at or past `total` are zero
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int total, int tid) {
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        row0 + r < total
            ? to_f32(src[static_cast<int64_t>(row0 + r) * D + c])
            : 0.f;
  }
}

// s[u][v] = Q[r] . K[c] and dp[u][v] = dO[r] . V[c] for the thread's rows
// r = ty + 16 u and keys c = tx + 16 v
template <int D, int TU, int TV>
__device__ __forceinline__ void scores(float (&s)[TU][TV],
                                       float (&dp)[TU][TV], const float* Qs,
                                       const float* dOs, const float* Ks,
                                       const float* Vs, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int v = 0; v < TV; ++v) s[u][v] = dp[u][v] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float q[TU], o[TU], kk[TV], vv[TV];
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      q[u] = Qs[(ty + 16 * u) * LD + d];
      o[u] = dOs[(ty + 16 * u) * LD + d];
    }
#pragma unroll
    for (int v = 0; v < TV; ++v) {
      kk[v] = Ks[(tx + 16 * v) * LD + d];
      vv[v] = Vs[(tx + 16 * v) * LD + d];
    }
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int v = 0; v < TV; ++v) {
        s[u][v] = fmaf(q[u], kk[v], s[u][v]);
        dp[u][v] = fmaf(o[u], vv[v], dp[u][v]);
      }
  }
}

// whether query i sees key j
__device__ __forceinline__ bool visible(int i, int j, int Sq, int Sk,
                                        int offset, int causal) {
  return i < Sq && j < Sk && (!causal || j <= i + offset);
}

// P = exp2(s scale_log2 - c) / l and dS of the thread's (row, key) pairs
// into Ps / dSs (rows of kLdS floats; Ps may be null); masked pairs,
// padded rows and padded keys give 0
template <int D, int TU, int TV>
__device__ __forceinline__ void probs(float* Ps, float* dSs,
                                      const float (&s)[TU][TV],
                                      const float (&dp)[TU][TV],
                                      const float* c_s, const float* il_s,
                                      const float* D_s, int q0, int k0,
                                      int Sq, int Sk, int offset, int causal,
                                      float scale_log2, int ty, int tx) {
  constexpr int LDS = Tiles<D>::kLdS;
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    const int r = ty + 16 * u, i = q0 + r;
#pragma unroll
    for (int v = 0; v < TV; ++v) {
      const int c = tx + 16 * v, j = k0 + c;
      const float p = visible(i, j, Sq, Sk, offset, causal)
                          ? exp2f(s[u][v] * scale_log2 - c_s[r]) * il_s[r]
                          : 0.f;
      if (Ps) Ps[r * LDS + c] = p;
      dSs[r * LDS + c] = p * (dp[u][v] - D_s[r]);
    }
  }
}

// the row terms of query rows [q0, q0 + rows): c = lse log2(e), and 1 / l
// and D from the row pass (with `stats` null, c alone); rows past Sq get 0
// (their P is masked)
__device__ __forceinline__ void stage_rows(float* c_s, float* il_s,
                                           float* D_s, const float* lse,
                                           const float2* stats,
                                           int64_t row_base, int q0, int Sq,
                                           int rows, int tid) {
  constexpr float kLog2e = 1.4426950408889634f;
  for (int r = tid; r < rows; r += kThreads) {
    const bool in = q0 + r < Sq;
    const int64_t i = row_base + q0 + r;
    c_s[r] = in ? lse[i] * kLog2e : 0.f;
    if (stats) {
      const float2 st = in ? stats[i] : make_float2(0.f, 0.f);
      il_s[r] = st.x;
      D_s[r] = st.y;
    }
  }
}

// the key tiles a query tile [q0, q0 + BQ) sees: up to its causal diagonal
template <int BQ, int BK>
__device__ __forceinline__ int key_tiles(int q0, int Sq, int Sk, int offset,
                                         int causal) {
  const int n_kt = (Sk + BK - 1) / BK;
  if (!causal) return n_kt;
  const int last_k = min(q0 + BQ, Sq) - 1 + offset;
  return last_k < 0 ? 0 : min(n_kt, last_k / BK + 1);
}

// --------------------------------------------------------- 1. row pass
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dO,
                     const float* __restrict__ lse,
                     float2* __restrict__ stats, int H, int Hkv, int Sq,
                     int Sk, int causal, float scale_log2) {
  using C = Tiles<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd;
  constexpr int TU = BQ / 16, TV = BK / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* c_s = Vs + BK * LD;
  float* part_l = c_s + BQ;       // BQ x 16: the 16 threads of a row
  float* part_d = part_l + BQ * 16;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int offset = Sk - Sq;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t bk = static_cast<int64_t>(b) * Hkv + h / (H / Hkv);

  stage<D, BQ>(Qs, q + bh * Sq * D, q0, Sq, tid);
  stage<D, BQ>(dOs, dO + bh * Sq * D, q0, Sq, tid);
  stage_rows(c_s, nullptr, nullptr, lse, nullptr, bh * Sq, q0, Sq, BQ, tid);

  // each key tile's sums alone, then added to the row's totals
  float sum_l[TU], sum_d[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) sum_l[u] = sum_d[u] = 0.f;
  const int n_kt = key_tiles<BQ, BK>(q0, Sq, Sk, offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's operands are consumed
    stage<D, BK>(Ks, k + bk * Sk * D, k0, Sk, tid);
    stage<D, BK>(Vs, v + bk * Sk * D, k0, Sk, tid);
    __syncthreads();
    float s[TU][TV], dp[TU][TV];
    scores<D>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const int r = ty + 16 * u;
      float tl = 0.f, td = 0.f;
#pragma unroll
      for (int w = 0; w < TV; ++w) {
        if (!visible(q0 + r, k0 + tx + 16 * w, Sq, Sk, offset, causal))
          continue;
        const float e = exp2f(s[u][w] * scale_log2 - c_s[r]);
        tl += e;
        td = fmaf(e, dp[u][w], td);
      }
      sum_l[u] += tl;
      sum_d[u] += td;
    }
  }
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    part_l[(ty + 16 * u) * 16 + tx] = sum_l[u];
    part_d[(ty + 16 * u) * 16 + tx] = sum_d[u];
  }
  __syncthreads();
  for (int r = tid; r < BQ; r += kThreads) {
    if (q0 + r >= Sq) continue;
    float l = 0.f, dsum = 0.f;
    for (int t = 0; t < 16; ++t) {
      l += part_l[r * 16 + t];
      dsum += part_d[r * 16 + t];
    }
    stats[bh * Sq + q0 + r] =
        l > 0.f ? make_float2(1.f / l, dsum / l) : make_float2(0.f, 0.f);
  }
}

// ---------------------------------------------------------- 2. dK, dV
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse,
                const float2* __restrict__ stats, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Hkv,
                int Sq, int Sk, int causal, float scale, float scale_log2) {
  using C = Tiles<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd, LDS = C::kLdS;
  constexpr int TU = BQ / 16, TV = BK / 16;  // score tile of a thread
  constexpr int TK = BK / 16, TD = D / 16;   // dK / dV tile of a thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDS;
  float* c_s = dSs + BQ * LDS;
  float* il_s = c_s + BQ;
  float* D_s = il_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv, offset = Sk - Sq;
  const int64_t bk = static_cast<int64_t>(b) * Hkv + hk;

  stage<D, BK>(Ks, k + bk * Sk * D, k0, Sk, tid);
  stage<D, BK>(Vs, v + bk * Sk * D, k0, Sk, tid);

  float acc_k[TK][TD], acc_v[TK][TD];
#pragma unroll
  for (int u = 0; u < TK; ++u)
#pragma unroll
    for (int w = 0; w < TD; ++w) acc_k[u][w] = acc_v[u][w] = 0.f;

  // the first query row that sees key k0
  const int first = causal ? max(0, k0 - offset) : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int hh = 0; hh < group; ++hh) {
    const int64_t bh = static_cast<int64_t>(b) * H + hk * group + hh;
    for (int qt = first / BQ; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's operands are consumed
      stage<D, BQ>(Qs, q + bh * Sq * D, q0, Sq, tid);
      stage<D, BQ>(dOs, dO + bh * Sq * D, q0, Sq, tid);
      stage_rows(c_s, il_s, D_s, lse, stats, bh * Sq, q0, Sq, BQ, tid);
      __syncthreads();
      float s[TU][TV], dp[TU][TV];
      scores<D>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
      probs<D>(Ps, dSs, s, dp, c_s, il_s, D_s, q0, k0, Sq, Sk, offset,
               causal, scale_log2, ty, tx);
      __syncthreads();
      // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
      // for the thread's keys c = ty + 16 u and columns d = tx + 16 w; the
      // tile's sum in fresh registers, folded into the total after it
      float tile_k[TK][TD], tile_v[TK][TD];
#pragma unroll
      for (int u = 0; u < TK; ++u)
#pragma unroll
        for (int w = 0; w < TD; ++w) tile_k[u][w] = tile_v[u][w] = 0.f;
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float p[TK], ds[TK], o[TD], qq[TD];
#pragma unroll
        for (int u = 0; u < TK; ++u) {
          p[u] = Ps[r * LDS + ty + 16 * u];
          ds[u] = dSs[r * LDS + ty + 16 * u];
        }
#pragma unroll
        for (int w = 0; w < TD; ++w) {
          o[w] = dOs[r * LD + tx + 16 * w];
          qq[w] = Qs[r * LD + tx + 16 * w];
        }
#pragma unroll
        for (int u = 0; u < TK; ++u)
#pragma unroll
          for (int w = 0; w < TD; ++w) {
            tile_v[u][w] = fmaf(p[u], o[w], tile_v[u][w]);
            tile_k[u][w] = fmaf(ds[u], qq[w], tile_k[u][w]);
          }
      }
#pragma unroll
      for (int u = 0; u < TK; ++u)
#pragma unroll
        for (int w = 0; w < TD; ++w) {
          acc_v[u][w] += tile_v[u][w];
          acc_k[u][w] += tile_k[u][w];
        }
    }
  }

#pragma unroll
  for (int u = 0; u < TK; ++u) {
    const int j = k0 + ty + 16 * u;
    if (j >= Sk) continue;
    T* kr = dk + (bk * Sk + j) * D;
    T* vr = dv + (bk * Sk + j) * D;
#pragma unroll
    for (int w = 0; w < TD; ++w) {
      store(kr + tx + 16 * w, acc_k[u][w] * scale);
      store(vr + tx + 16 * w, acc_v[u][w]);
    }
  }
}

// --------------------------------------------------------------- 3. dQ
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dO,
              const float* __restrict__ lse,
              const float2* __restrict__ stats, T* __restrict__ dq, int H,
              int Hkv, int Sq, int Sk, int causal,
              float scale, float scale_log2) {
  using C = Tiles<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, LD = C::kLd, LDS = C::kLdS;
  constexpr int TU = BQ / 16, TV = BK / 16;  // score tile of a thread
  constexpr int TD = D / 16;                 // dQ columns of a thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* c_s = dSs + BQ * LDS;
  float* il_s = c_s + BQ;
  float* D_s = il_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int offset = Sk - Sq;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t bk = static_cast<int64_t>(b) * Hkv + h / (H / Hkv);

  stage<D, BQ>(Qs, q + bh * Sq * D, q0, Sq, tid);
  stage<D, BQ>(dOs, dO + bh * Sq * D, q0, Sq, tid);
  stage_rows(c_s, il_s, D_s, lse, stats, bh * Sq, q0, Sq, BQ, tid);

  const int n_kt = key_tiles<BQ, BK>(q0, Sq, Sk, offset, causal);
  float acc[TU][TD];
#pragma unroll
  for (int u = 0; u < TU; ++u)
#pragma unroll
    for (int w = 0; w < TD; ++w) acc[u][w] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's operands are consumed
    stage<D, BK>(Ks, k + bk * Sk * D, k0, Sk, tid);
    stage<D, BK>(Vs, v + bk * Sk * D, k0, Sk, tid);
    __syncthreads();
    float s[TU][TV], dp[TU][TV];
    scores<D>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
    probs<D>(nullptr, dSs, s, dp, c_s, il_s, D_s, q0, k0, Sq, Sk, offset,
             causal, scale_log2, ty, tx);
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d] for rows r = ty + 16 u, d = tx + 16 w;
    // the tile's sum in fresh registers, folded into the total after it
    float tile[TU][TD];
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int w = 0; w < TD; ++w) tile[u][w] = 0.f;
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float ds[TU], kk[TD];
#pragma unroll
      for (int u = 0; u < TU; ++u) ds[u] = dSs[(ty + 16 * u) * LDS + c];
#pragma unroll
      for (int w = 0; w < TD; ++w) kk[w] = Ks[c * LD + tx + 16 * w];
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int w = 0; w < TD; ++w)
          tile[u][w] = fmaf(ds[u], kk[w], tile[u][w]);
    }
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int w = 0; w < TD; ++w) acc[u][w] += tile[u][w];
  }

#pragma unroll
  for (int u = 0; u < TU; ++u) {
    const int i = q0 + ty + 16 * u;
    if (i >= Sq) continue;
    T* qr = dq + (bh * Sq + i) * D;
#pragma unroll
    for (int w = 0; w < TD; ++w) store(qr + tx + 16 * w, acc[u][w] * scale);
  }
}

// ------------------------------------------------------------ launches
template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int D, typename T>
int run(const void* q, const void* k, const void* v, const void* dO,
        const float* lse, float2* stats, void* dq, void* dk, void* dv, int B,
        int H, int Hkv, int Sq, int Sk, int causal, cudaStream_t stream) {
  using C = Tiles<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  // the forward's own constant, so x = s scale_log2 rounds as it did there
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  const dim3 q_grid((Sq + C::kBQ - 1) / C::kBQ, H, B);
  int err = set_smem(row_stats_kernel<D, T>, C::kRowBytes);
  if (err) return err;
  row_stats_kernel<D, T><<<q_grid, kThreads, C::kRowBytes, stream>>>(
      qt, kt, vt, dOt, lse, stats, H, Hkv, Sq, Sk, causal, scale_log2);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = set_smem(dkdv_kernel<D, T>, C::kKvBytes))) return err;
  dkdv_kernel<D, T><<<dim3((Sk + C::kBK - 1) / C::kBK, Hkv, B), kThreads,
                      C::kKvBytes, stream>>>(
      qt, kt, vt, dOt, lse, stats, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, Sq, Sk, causal, scale, scale_log2);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = set_smem(dq_kernel<D, T>, C::kQBytes))) return err;
  dq_kernel<D, T><<<q_grid, kThreads, C::kQBytes, stream>>>(
      qt, kt, vt, dOt, lse, stats, static_cast<T*>(dq), H, Hkv, Sq, Sk,
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, Dh>) for a head dim with an instance
template <typename F>
int with_head_dim(int64_t Dh, F&& f) {
  switch (Dh) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(bool is_bf16, const void* q, const void* k, const void* v,
             const void* dO, const void* lse, void* stats, void* dq,
             void* dk, void* dv, int64_t B, int64_t H, int64_t Hkv,
             int64_t Sq, int64_t Sk, int64_t Dh, int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 || B > 65535 || Hkv > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk);
  const float* l = static_cast<const float*>(lse);
  float2* st = static_cast<float2*>(stats);
  return with_head_dim(Dh, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return is_bf16 ? run<kD, bf16>(q, k, v, dO, l, st, dq, dk, dv, b, h, hkv,
                                   sq, sk, causal, s)
                   : run<kD, float>(q, k, v, dO, l, st, dq, dk, dv, b, h,
                                    hkv, sq, sk, causal, s);
  });
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dO, dq (B, H, Sq, Dh) and k, v, dk, dv (B, Hkv, Sk, Dh), contiguous,
// one type; lse (B, H, Sq) float32 from the forward; stats a float32
// scratch of 2 B H Sq floats.  causal: 0 or 1.  Three launches.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* dO, const void* lse, void* stats,
                            void* dq, void* dk, void* dv, int64_t B,
                            int64_t H, int64_t Hkv, int64_t Sq, int64_t Sk,
                            int64_t Dh, int causal, void* stream) {
  return dispatch(false, q, k, v, dO, lse, stats, dq, dk, dv, B, H, Hkv, Sq,
                  Sk, Dh, causal, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* dO, const void* lse, void* stats,
                             void* dq, void* dk, void* dv, int64_t B,
                             int64_t H, int64_t Hkv, int64_t Sq, int64_t Sk,
                             int64_t Dh, int causal, void* stream) {
  return dispatch(true, q, k, v, dO, lse, stats, dq, dk, dv, B, H, Hkv, Sq,
                  Sk, Dh, causal, stream);
}

}  // extern "C"
