// Mamba2 SSD chunked scan on Hopper, in the chunk-parallel form.
//
// Replaces the Pallas TPU kernel `ssd_scan_tpu`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).  For each
// (b, h), over the sequence in tiles of T rows, with cs = cumsum(dA) within
// the tile:
//
//   L[i, j] = exp(cs[i] - cs[j])  for j <= i, 0 above the diagonal
//   y       = (C B^T o L) xdt + (C o exp(cs)) h_in^T
//   h_out   = exp(cs[T-1]) h_in + (xdt o exp(cs[T-1] - cs))^T B
//
// for xdt (B, H, S, P) (x pre-multiplied by dt), dA (B, H, S) float32,
// B/C (B, G, S, N); head h reads group h / (H / G).  The state starts at
// zero and is kept in float32; y is stored in xdt's type and the final state
// (B, H, P, N) in float32.  The exponential is computed only where j <= i:
// above the diagonal cs[i] - cs[j] is positive and exp may overflow (the
// TPU kernel masks it with `where` after computing it).
//
// What bounds it: operations.  Counted for the chunked form at a tile of
// Q rows, as the lower triangle of C B^T once per (b, group, tile) (the
// heads of a group share it) and, per (b, h, tile), its product with xdt,
// the carry-in product and the state update (Q P N each) and the state's
// decay (P N), the function needs the least at Q 8: at mamba2-2.7b's main
// shape (B 2, H 80, G 1, S 2048, P 64, N 128) 11.3 GFLOP, 0.168 ms at the
// card's non-tensor float32 rate, against 178.5 MB of inputs and outputs in
// float32, 0.053 ms at its memory rate.  In bfloat16 the same work is
// 0.011 ms at the tensor-core rate and the 91.8 MB of inputs and outputs
// bound it: 0.027 ms.
//
// Design.  The TPU walks the tiles on a sequential grid axis with the
// running (P, N) state in VMEM scratch.  Here every tile is independent
// except for the state it starts from, so the scan is three launches:
//
//   1. chunk states, grid (tiles, H, B): a block stages its tile's dA, B
//      and xdt, forms cs with a warp-parallel scan (shuffles), scales the
//      xdt rows by exp(cs[T-1] - cs[j]) as it stages them, and writes the
//      tile's own state s_c = (xdt o decay)^T B and exp(cs[T-1]) to the
//      workspace;
//   2. state passing, four (n, p) elements a thread: h_c = exp(cs_last_{c-1})
//      h_{c-1} + s_{c-1} over the tiles in order, overwriting s_c with the
//      state entering tile c, and writing the final state.  The loads of
//      the next batch of tiles are issued before this batch is stored;
//   3. chunk outputs, grid (tiles, heads / hpb, B): a block serves hpb
//      heads of one group (4 for mamba2's 80 heads over one group), forms
//      C B^T once for all of them, and for each head the masked, decayed
//      scores L o C B^T, then y = exp(cs) o (C h_in^T) + (L o C B^T) xdt.
//      Only j <= i is formed and multiplied: the steps over j stop at the
//      diagonal block of the rows a warp owns.
//
// float32 runs stages 1 and 3 on the CUDA cores in full float32 (no TF32;
// the non-tensor rate is its roof): 256 threads (16 x 16) run register-
// tiled outer-product loops over operands stored k-major in shared memory
// (C and B are transposed as they are staged), a thread holding a 4 x 4
// tile of a 64 x 64 output and 8 x 4 of the state's 128 x 64, read as
// float4s.  bfloat16 runs them on the tensor cores (the second half of
// this file): mma.sync m16n8k16 on bfloat16 tiles staged with padded rows,
// the scores kept in registers and packed as the A operand of the product
// with xdt, as flash attention does with P.
//
// Workspace (allocated by the wrapper, `ssd_scan_workspace_floats`): the
// per-tile states (B, H, tiles, N, P) float32 and the tile decays
// (B, H, tiles): 168 MB at the main shape (32 tiles of 64).  Passing it
// through device memory costs one write (stage 1), one read and one write
// (stage 2) and one read (stage 3): about 0.67 GB, 0.2 ms at 3.35 TB/s,
// which is more than the bfloat16 bound and comparable to the float32 one.
//
// The tile is T = min(chunk, 64) rows (the scan's result does not depend
// on where the sequence is cut, only the rounding does), so the entry
// point's default chunk of 128 runs as tiles of 64; a ragged last tile
// (chunk > 64 not a multiple of 64) has its rows past S zero with dA 0.
// P and N may be 1 .. 128, the chunk 1 .. S.  Two instances of each stage
// a type: mamba2's P 64, N 128, and one padded to P = N = 128 that serves
// every other size with its idle rows and columns zero; two of stage 2 (N P
// a multiple of 4 or not): ten kernels.  Shared memory at the main shape:
// float32 stage 1 49 KB, stage 3 98 KB (2 blocks an SM); bfloat16 27 and
// 63 KB.
//
// The entry points issue three launches per call; the Python wrapper
// counts one launch of `ssd_scan` per call.  They return the CUDA error
// code of the first launch that fails so the wrapper raises; the kernels
// allocate nothing.  Loads of 16 bytes need xdt, B and C 16-byte aligned
// (the wrapper sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kT = 64;         // rows of a tile, at most
constexpr int kMaxPN = 128;    // P and N

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// the output row (column) of a thread's u-th register row (column): 4
// consecutive ones at 4 * ty, then 64 further on
__device__ __forceinline__ int tile_index(int u, int t) {
  return 64 * (u / 4) + 4 * t + (u % 4);
}

// acc[u][v] += sum_k A[k][tile_index(u, ty)] * B[k][tile_index(v, tx)]
template <int TM, int TN>
__device__ __forceinline__ void gemm_kmajor(float (&acc)[TM][TN],
                                            const float* A, int lda,
                                            const float* B, int ldb, int K,
                                            int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int u = 0; u < TM / 4; ++u) {
      const float4 t = load4(A + k * lda + 64 * u + 4 * ty);
      a[4 * u] = t.x, a[4 * u + 1] = t.y, a[4 * u + 2] = t.z,
      a[4 * u + 3] = t.w;
    }
#pragma unroll
    for (int v = 0; v < TN / 4; ++v) {
      const float4 t = load4(B + k * ldb + 64 * v + 4 * tx);
      b[4 * v] = t.x, b[4 * v + 1] = t.y, b[4 * v + 2] = t.z,
      b[4 * v + 3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }
}

// cs[i] = dA[0] + ... + dA[i] for the tile's rows, dA 0 past `rows`: two
// warps scan 32 rows each with shuffles, the second then adds the first's
// total.  Ends with the sums visible to the block.
__device__ __forceinline__ void tile_cumsum(float* cs, const float* dA,
                                            int rows, int tid) {
  if (tid < kT) {
    float v = tid < rows ? dA[tid] : 0.f;
    const int lane = tid & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    cs[tid] = v;
  }
  __syncthreads();
  if (tid >= 32 && tid < kT) cs[tid] += cs[31];
  __syncthreads();
}

// rows [0, rows) x columns [0, cols) of a row-major (., cols) matrix into
// dst[r][c] (rows of LD floats, kT of them), optionally times scale[r];
// everything else of the kT x LD block is zero
template <int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows,
                                           int cols, const float* scale,
                                           int tid) {
  if (cols % 4 == 0) {
    for (int e = tid; e < kT * LD / 4; e += kThreads) {
      const int r = e / (LD / 4), c = 4 * (e % (LD / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < cols) {
        v = load4(src + static_cast<int64_t>(r) * cols + c);
        if (scale) {
          const float s = scale[r];
          v.x *= s, v.y *= s, v.z *= s, v.w *= s;
        }
      }
      store4(dst + r * LD + c, v);
    }
  } else {
    for (int e = tid; e < kT * LD; e += kThreads) {
      const int r = e / LD, c = e % LD;
      float v = 0.f;
      if (r < rows && c < cols) {
        v = src[static_cast<int64_t>(r) * cols + c];
        if (scale) v *= scale[r];
      }
      dst[e] = v;
    }
  }
}

// the same block transposed: dst[c][r] (rows of kT floats, KN of them);
// consecutive lanes take consecutive rows r, so the shared stores are free
// of bank conflicts
template <int KN>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src,
                                                 int rows, int cols,
                                                 int tid) {
  if (cols % 4 == 0) {
    for (int e = tid; e < kT * KN / 4; e += kThreads) {
      const int r = e % kT, c = 4 * (e / kT);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < cols)
        v = load4(src + static_cast<int64_t>(r) * cols + c);
      dst[c * kT + r] = v.x;
      dst[(c + 1) * kT + r] = v.y;
      dst[(c + 2) * kT + r] = v.z;
      dst[(c + 3) * kT + r] = v.w;
    }
  } else {
    for (int e = tid; e < kT * KN; e += kThreads) {
      const int r = e % kT, c = e / kT;
      dst[e] = r < rows && c < cols ? src[static_cast<int64_t>(r) * cols + c]
                                    : 0.f;
    }
  }
}

struct Shape {
  int H, G, S, P, N, Tq, nT;
};

// ---------------------------------------------------- 1. chunk states
template <int KP, int KN>
struct StateSmem {
  static constexpr size_t kFloats =
      static_cast<size_t>(kT) * KN + kT * KP + kT + kT;
};

template <int KP, int KN>
__global__ void __launch_bounds__(kThreads)
    chunk_state_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ dA,
                       const float* __restrict__ Bm, float* __restrict__ ws,
                       float* __restrict__ decay, Shape d) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;            // kT x KN: B rows j
  float* Xs = Bs + kT * KN;    // kT x KP: xdt rows j, decayed to the end
  float* cs = Xs + kT * KP;    // kT
  float* dec = cs + kT;        // kT: exp(cs[T-1] - cs[j])

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;

  tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
  const float last = cs[kT - 1];
  if (tid < kT) dec[tid] = expf(last - cs[tid]);
  __syncthreads();
  stage_rows<KN>(Bs, Bm + (static_cast<int64_t>(b) * d.G + g) * d.S * d.N +
                         static_cast<int64_t>(s0) * d.N,
                 rows, d.N, nullptr, tid);
  stage_rows<KP>(Xs, xdt + (bh * d.S + s0) * d.P, rows, d.P, dec, tid);
  __syncthreads();

  // s[n][p] = sum_j B[j][n] xdt'[j][p]
  constexpr int TM = KN / 16, TN = KP / 16;
  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
  gemm_kmajor<TM, TN>(acc, Bs, KN, Xs, KP, rows, ty, tx);

  float* wb = ws + (bh * d.nT + c) * d.N * d.P;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int n = tile_index(u, ty);
    if (n >= d.N) continue;
#pragma unroll
    for (int v = 0; v < TN; v += 4) {
      const int p = tile_index(v, tx);
      if (d.P % 4 == 0) {
        if (p < d.P)
          store4(wb + n * d.P + p, make_float4(acc[u][v], acc[u][v + 1],
                                               acc[u][v + 2], acc[u][v + 3]));
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (p + w < d.P) wb[n * d.P + p + w] = acc[u][v + w];
      }
    }
  }
  if (tid == 0) decay[bh * d.nT + c] = expf(last);
}

// -------------------------------------------------- 2. state passing
// ws[bh][c] <- the state entering tile c; st[bh] <- the state after the last.
// A thread owns four consecutive (n, p) elements (float4; N P a multiple of
// 4) and walks the tiles in batches of kBatch, loading the next batch
// before it stores this one, so two batches of loads are in flight: one
// dependent load a tile would leave the thread waiting on memory nT times.
constexpr int kBatch = 4;

__device__ __forceinline__ void write_final(float* st, int64_t bh, int e,
                                            float v, int P, int N) {
  const int n = e / P, p = e % P;
  st[bh * N * P + static_cast<int64_t>(p) * N + n] = v;
}

__global__ void __launch_bounds__(kThreads)
    state_pass_kernel(float* __restrict__ ws, const float* __restrict__ decay,
                      float* __restrict__ st, int nT, int P, int N) {
  const int NP = N * P;
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= NP) return;
  const int64_t bh = blockIdx.y;
  float4* w = reinterpret_cast<float4*>(ws + bh * nT * NP + e);
  const int64_t stride = NP / 4;
  const float* dc = decay + bh * nT;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (u < nT) cur[u] = w[u * stride];
  for (int c0 = 0; c0 < nT; c0 += kBatch) {
    float4 nxt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + kBatch + u < nT) nxt[u] = w[(c0 + kBatch + u) * stride];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u >= nT) break;
      w[(c0 + u) * stride] = run;
      const float d = dc[c0 + u];
      run.x = fmaf(d, run.x, cur[u].x);
      run.y = fmaf(d, run.y, cur[u].y);
      run.z = fmaf(d, run.z, cur[u].z);
      run.w = fmaf(d, run.w, cur[u].w);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
  }
  write_final(st, bh, e, run.x, P, N);
  write_final(st, bh, e + 1, run.y, P, N);
  write_final(st, bh, e + 2, run.z, P, N);
  write_final(st, bh, e + 3, run.w, P, N);
}

// the same, one element a thread, for N P not a multiple of 4
__global__ void __launch_bounds__(kThreads)
    state_pass_scalar_kernel(float* __restrict__ ws,
                             const float* __restrict__ decay,
                             float* __restrict__ st, int nT, int P, int N) {
  const int NP = N * P;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int64_t bh = blockIdx.y;
  float* w = ws + bh * nT * NP + e;
  const float* dc = decay + bh * nT;
  float run = 0.f;
  for (int c = 0; c < nT; ++c) {
    const float s = w[static_cast<int64_t>(c) * NP];
    w[static_cast<int64_t>(c) * NP] = run;
    run = fmaf(dc[c], run, s);
  }
  write_final(st, bh, e, run, P, N);
}

// -------------------------------------------------- 3. chunk outputs
template <int KP, int KN>
struct OutSmem {
  static constexpr int kR = KN * (KP > kT ? KP : kT);  // B^T, then h_in
  static constexpr size_t kFloats = static_cast<size_t>(KN) * kT +
                                    kT * KP + kT * kT + kR + kT;
};

template <int KP, int KN>
__global__ void __launch_bounds__(kThreads)
    chunk_out_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ dA,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ ws, float* __restrict__ y,
                     Shape d, int hpb) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                 // KN x kT: C transposed
  float* Xs = Ct + KN * kT;         // kT x KP: xdt rows j
  float* St = Xs + kT * KP;         // kT x kT: scores transposed, [j][i]
  float* R = St + kT * kT;          // KN x kT: B transposed; then KN x KP h_in
  float* cs = R + OutSmem<KP, KN>::kR;  // kT

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpb;  // hpb heads of one group
  const int g = h0 / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bg = (static_cast<int64_t>(b) * d.G + g) * d.S + s0;

  stage_transposed<KN>(Ct, Cm + bg * d.N, rows, d.N, tid);
  stage_transposed<KN>(R, Bm + bg * d.N, rows, d.N, tid);
  __syncthreads();
  // C_i . B_j, shared by the heads of the group: raw[u][v] at j = 4 ty + u,
  // i = 4 tx + v, kept in registers across the heads
  float raw[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) raw[u][v] = 0.f;
  gemm_kmajor<4, 4>(raw, R, kT, Ct, kT, d.N, ty, tx);

  constexpr int TN = KP / 16;
  // the rows i of a warp end at 8 (ty / 2) + 7: later j see no row of it
  const int k_intra = min(rows, 8 * (ty / 2) + 8);
  for (int hh = 0; hh < hpb; ++hh) {
    const int h = h0 + hh;
    const int64_t bh = static_cast<int64_t>(b) * d.H + h;
    __syncthreads();  // B^T, or the previous head's operands, are consumed
    tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
    // st[j][i] = (C_i . B_j) exp(cs[i] - cs[j]) for j <= i, else 0
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * ty + u;
      float o[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 4 * tx + v;
        o[v] = j <= i ? raw[u][v] * expf(cs[i] - cs[j]) : 0.f;
      }
      store4(St + j * kT + 4 * tx, make_float4(o[0], o[1], o[2], o[3]));
    }
    stage_rows<KP>(Xs, xdt + (bh * d.S + s0) * d.P, rows, d.P, nullptr, tid);
    if (c > 0) {  // the first tile starts from the zero state
      const float* wb = ws + (bh * d.nT + c) * d.N * d.P;
      for (int e = tid; e < KN * KP; e += kThreads) {
        const int n = e / KP, p = e % KP;
        R[e] = n < d.N && p < d.P ? wb[n * d.P + p] : 0.f;
      }
    }
    __syncthreads();

    float acc[4][TN];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
    if (c > 0) {
      // y[i][p] = exp(cs[i]) sum_n C[i][n] h_in[p][n]
      gemm_kmajor<4, TN>(acc, Ct, kT, R, KP, d.N, ty, tx);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float e = expf(cs[4 * ty + u]);
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] *= e;
      }
    }
    // y[i][p] += sum_{j <= i} st[j][i] xdt[j][p]
    gemm_kmajor<4, TN>(acc, St, kT, Xs, KP, k_intra, ty, tx);

    float* yb = y + (bh * d.S + s0) * d.P;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * ty + u;
      if (i >= rows) continue;
#pragma unroll
      for (int v = 0; v < TN; v += 4) {
        const int p = tile_index(v, tx);
        if (d.P % 4 == 0) {
          if (p < d.P)
            store4(yb + static_cast<int64_t>(i) * d.P + p,
                   make_float4(acc[u][v], acc[u][v + 1], acc[u][v + 2],
                               acc[u][v + 3]));
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (p + w < d.P) yb[static_cast<int64_t>(i) * d.P + p + w] =
                acc[u][v + w];
        }
      }
    }
  }
}

// ------------------------------------------ bfloat16, on the tensor cores
// Stages 1 and 3 again, with their products as mma.sync.m16n8k16 (bfloat16
// operands, float32 accumulators).  The tiles are staged as bfloat16 rows
// padded by 8 elements (16 bytes), so the eight row addresses of every
// ldmatrix fall in eight different 16-byte bank groups.  What is rounded
// to bfloat16: the decayed xdt (stage 1), L o C B^T and the state entering
// the tile (stage 3), where each becomes a product operand; the inputs
// are bfloat16 already, the workspace and every sum stay float32.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x, v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = load4(p), b = load4(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// rows [0, rows) x columns [0, cols) of a row-major (., cols) matrix into
// bfloat16 dst[r][c] (rows of LD elements), optionally times scale[r];
// the rest of the ROWS x WIDTH block is zero
template <int ROWS, int WIDTH, int LD, int NTHREADS, typename T>
__device__ __forceinline__ void stage_bf16(bf16* dst, const T* src, int rows,
                                           int cols, const float* scale,
                                           int tid) {
  for (int e = tid; e < ROWS * WIDTH / 8; e += NTHREADS) {
    const int r = e / (WIDTH / 8), c = 8 * (e % (WIDTH / 8));
    const T* row = src + static_cast<int64_t>(r) * cols;
    float v[8];
    if (r < rows && cols % 8 == 0 && c < cols) {
      load8(row + c, v);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = r < rows && c + q < cols ? to_f32(row[c + q]) : 0.f;
    }
    if (scale && r < rows) {
      const float s = scale[r];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] *= s;
    }
    uint4 u;
    u.x = pack_bf16(v[0], v[1]), u.y = pack_bf16(v[2], v[3]);
    u.z = pack_bf16(v[4], v[5]), u.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = u;
  }
}

template <int KP, int KN>
struct TcSmem {
  static constexpr int kLdN = KN + 8, kLdP = KP + 8;  // padded rows
  // stage 1: B (kT x KN), decayed xdt (kT x KP), cs and decays
  static constexpr size_t kState =
      sizeof(bf16) * kT * (kLdN + kLdP) + sizeof(float) * 2 * kT;
  // stage 3: C and B (kT x KN), xdt (kT x KP), h_in (KN x KP), cs
  static constexpr size_t kOut =
      sizeof(bf16) * (2 * kT * kLdN + kT * kLdP + KN * kLdP) +
      sizeof(float) * kT;
};

// stage 1: 8 warps, warp w owns state rows n in [16 w, 16 w + 16) and every
// column p: s[n][p] = sum_j B[j][n] xdt'[j][p], K = the tile's 64 rows
template <int KP, int KN>
__global__ void __launch_bounds__(kThreads)
    chunk_state_tc_kernel(const bf16* __restrict__ xdt,
                          const float* __restrict__ dA,
                          const bf16* __restrict__ Bm, float* __restrict__ ws,
                          float* __restrict__ decay, Shape d) {
  static_assert(KN == 16 * (kThreads / 32), "one m16 tile of n a warp");
  constexpr int LDN = TcSmem<KP, KN>::kLdN, LDP = TcSmem<KP, KN>::kLdP;
  constexpr int NT = KP / 8;  // 8-wide tiles of p
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // kT x LDN
  bf16* Xs = Bs + kT * LDN;                        // kT x LDP, decayed
  float* cs = reinterpret_cast<float*>(Xs + kT * LDP);
  float* dec = cs + kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lr = lane & 7, lm = lane >> 3, g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;

  tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
  const float last = cs[kT - 1];
  if (tid < kT) dec[tid] = expf(last - cs[tid]);
  __syncthreads();
  stage_bf16<kT, KN, LDN, kThreads>(
      Bs, Bm + ((static_cast<int64_t>(b) * d.G + grp) * d.S + s0) * d.N,
      rows, d.N, nullptr, tid);
  stage_bf16<kT, KP, LDP, kThreads>(Xs, xdt + (bh * d.S + s0) * d.P, rows,
                                    d.P, dec, tid);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t a[4];  // B^T rows n, columns j: B is stored [j][n]
    ldsm_x4_trans(smem_addr(Bs + (kk * 16 + (lm >> 1) * 8 + lr) * LDN +
                            16 * warp + (lm & 1) * 8),
                  a);
#pragma unroll
    for (int t = 0; t < NT; t += 2) {
      uint32_t bb[4];
      ldsm_x4_trans(smem_addr(Xs + (kk * 16 + (lm & 1) * 8 + lr) * LDP +
                              (t + (lm >> 1)) * 8),
                    bb);
      mma_bf16(acc[t], a, bb[0], bb[1]);
      mma_bf16(acc[t + 1], a, bb[2], bb[3]);
    }
  }

  float* wb = ws + (bh * d.nT + c) * d.N * d.P;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int p = 8 * t + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = 16 * warp + g + 8 * half;
      if (n >= d.N) continue;
      if (p < d.P) wb[n * d.P + p] = acc[t][2 * half];
      if (p + 1 < d.P) wb[n * d.P + p + 1] = acc[t][2 * half + 1];
    }
  }
  if (tid == 0) decay[bh * d.nT + c] = expf(last);
}

// stage 3: 4 warps, warp w owns rows i in [16 w, 16 w + 16) of the tile
constexpr int kTcOutThreads = 128;

template <int KP, int KN>
__global__ void __launch_bounds__(kTcOutThreads)
    chunk_out_tc_kernel(const bf16* __restrict__ xdt,
                        const float* __restrict__ dA,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm,
                        const float* __restrict__ ws, bf16* __restrict__ y,
                        Shape d, int hpb) {
  constexpr int LDN = TcSmem<KP, KN>::kLdN, LDP = TcSmem<KP, KN>::kLdP;
  constexpr int NT = KP / 8;  // 8-wide tiles of p
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // kT x LDN, [i][n]
  bf16* Bs = Cs + kT * LDN;                        // kT x LDN, [j][n]
  bf16* Xs = Bs + kT * LDN;                        // kT x LDP, [j][p]
  bf16* Hs = Xs + kT * LDP;                        // KN x LDP, [n][p]
  float* cs = reinterpret_cast<float*>(Hs + KN * LDP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lr = lane & 7, lm = lane >> 3, g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, b = blockIdx.z;
  const int h0 = blockIdx.y * hpb;  // hpb heads of one group
  const int grp = h0 / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bg = (static_cast<int64_t>(b) * d.G + grp) * d.S + s0;
  const int kn = (d.N + 15) / 16;  // 16-wide steps over n
  // this lane's two rows, and the 8-wide column tiles j <= the warp's
  // last row (2 (warp + 1) of them)
  const int i0 = 16 * warp + g, i1 = i0 + 8;
  const int jt_end = 2 * (warp + 1);

  stage_bf16<kT, KN, LDN, kTcOutThreads>(Cs, Cm + bg * d.N, rows, d.N,
                                         nullptr, tid);
  stage_bf16<kT, KN, LDN, kTcOutThreads>(Bs, Bm + bg * d.N, rows, d.N,
                                         nullptr, tid);
  __syncthreads();

  // C_i . B_j, shared by the heads: sc[jt] holds columns 8 jt ..
  const uint32_t c_addr =
      smem_addr(Cs + (16 * warp + lr + (lm & 1) * 8) * LDN + (lm >> 1) * 8);
  float sc[kT / 8][4];
#pragma unroll
  for (int jt = 0; jt < kT / 8; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[jt][e] = 0.f;
  for (int kk = 0; kk < kn; ++kk) {
    uint32_t a[4];
    ldsm_x4(c_addr + kk * 32, a);
#pragma unroll
    for (int jt = 0; jt < kT / 8; jt += 2) {
      if (jt >= jt_end) break;
      uint32_t bb[4];
      ldsm_x4(smem_addr(Bs + ((jt + (lm >> 1)) * 8 + lr) * LDN + kk * 16 +
                        (lm & 1) * 8),
              bb);
      mma_bf16(sc[jt], a, bb[0], bb[1]);
      mma_bf16(sc[jt + 1], a, bb[2], bb[3]);
    }
  }

  for (int hh = 0; hh < hpb; ++hh) {
    const int h = h0 + hh;
    const int64_t bh = static_cast<int64_t>(b) * d.H + h;
    __syncthreads();  // the previous head's operands are consumed
    tile_cumsum(cs, dA + bh * d.S + s0, rows, tid);
    stage_bf16<kT, KP, LDP, kTcOutThreads>(Xs, xdt + (bh * d.S + s0) * d.P,
                                           rows, d.P, nullptr, tid);
    if (c > 0)
      stage_bf16<KN, KP, LDP, kTcOutThreads>(
          Hs, ws + (bh * d.nT + c) * d.N * d.P, d.N, d.P, nullptr, tid);
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    if (c > 0) {
      // exp(cs[i]) sum_n C[i][n] h_in[p][n]
      for (int kk = 0; kk < kn; ++kk) {
        uint32_t a[4];
        ldsm_x4(c_addr + kk * 32, a);
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          uint32_t bb[4];
          ldsm_x4_trans(smem_addr(Hs + (kk * 16 + (lm & 1) * 8 + lr) * LDP +
                                  (t + (lm >> 1)) * 8),
                        bb);
          mma_bf16(acc[t], a, bb[0], bb[1]);
          mma_bf16(acc[t + 1], a, bb[2], bb[3]);
        }
      }
      const float e0 = expf(cs[i0]), e1 = expf(cs[i1]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[t][0] *= e0, acc[t][1] *= e0;
        acc[t][2] *= e1, acc[t][3] *= e1;
      }
    }
    // + (L o C B^T) xdt, L o C B^T packed from the score registers; the
    // 16-wide steps over j stop at the warp's diagonal block
    const float cs0 = cs[i0], cs1 = cs[i1];
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (kk > warp) break;
      float v[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = 2 * kk + u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * jt + 2 * t4 + (e & 1);
          const int i = e < 2 ? i0 : i1;
          v[u][e] = j <= i ? sc[jt][e] * expf((e < 2 ? cs0 : cs1) - cs[j])
                           : 0.f;
        }
      }
      const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]),
                             pack_bf16(v[0][2], v[0][3]),
                             pack_bf16(v[1][0], v[1][1]),
                             pack_bf16(v[1][2], v[1][3])};
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(smem_addr(Xs + (kk * 16 + (lm & 1) * 8 + lr) * LDP +
                                (t + (lm >> 1)) * 8),
                      bb);
        mma_bf16(acc[t], a, bb[0], bb[1]);
        mma_bf16(acc[t + 1], a, bb[2], bb[3]);
      }
    }

    bf16* yb = y + (bh * d.S + s0) * d.P;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int p = 8 * t + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        if (i >= rows || p >= d.P) continue;
        bf16* out = yb + static_cast<int64_t>(i) * d.P + p;
        if (d.P % 2 == 0)
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
              acc[t][2 * half], acc[t][2 * half + 1]);
        else {
          out[0] = __float2bfloat16(acc[t][2 * half]);
          if (p + 1 < d.P) out[1] = __float2bfloat16(acc[t][2 * half + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches
struct Args {
  const void *xdt, *dA, *Bm, *Cm;
  void *y, *st, *ws;
  int B, stages;
  Shape d;
  cudaStream_t stream;
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// heads a stage-3 block serves: C B^T is formed once for all of them
int heads_per_block(const Shape& d) {
  const int rep = d.H / d.G;
  return rep % 4 == 0 ? 4 : rep % 2 == 0 ? 2 : 1;
}

int state_pass(const Args& a, float* ws, float* decay) {
  const Shape& d = a.d;
  const int NP = d.N * d.P;
  float* st = static_cast<float*>(a.st);
  if (NP % 4 == 0)
    state_pass_kernel<<<dim3((NP / 4 + kThreads - 1) / kThreads, a.B * d.H),
                        kThreads, 0, a.stream>>>(ws, decay, st, d.nT, d.P,
                                                 d.N);
  else
    state_pass_scalar_kernel<<<dim3((NP + kThreads - 1) / kThreads,
                                    a.B * d.H),
                               kThreads, 0, a.stream>>>(ws, decay, st, d.nT,
                                                        d.P, d.N);
  return static_cast<int>(cudaGetLastError());
}

// float32: the CUDA-core kernels
template <int KP, int KN>
int run_f32(const Args& a) {
  const Shape& d = a.d;
  float* ws = static_cast<float*>(a.ws);
  float* decay = ws + static_cast<int64_t>(a.B) * d.H * d.nT * d.N * d.P;
  const float* xdt = static_cast<const float*>(a.xdt);
  const float* dA = static_cast<const float*>(a.dA);
  const float* Bm = static_cast<const float*>(a.Bm);
  const float* Cm = static_cast<const float*>(a.Cm);

  const size_t s1 = sizeof(float) * StateSmem<KP, KN>::kFloats;
  int err = set_smem(chunk_state_kernel<KP, KN>, s1);
  if (err) return err;
  chunk_state_kernel<KP, KN><<<dim3(d.nT, d.H, a.B), kThreads, s1,
                               a.stream>>>(xdt, dA, Bm, ws, decay, d);
  if ((err = static_cast<int>(cudaGetLastError())) || a.stages < 2)
    return err;
  if ((err = state_pass(a, ws, decay)) || a.stages < 3) return err;
  const int hpb = heads_per_block(d);
  const size_t s3 = sizeof(float) * OutSmem<KP, KN>::kFloats;
  if ((err = set_smem(chunk_out_kernel<KP, KN>, s3))) return err;
  chunk_out_kernel<KP, KN><<<dim3(d.nT, d.H / hpb, a.B), kThreads, s3,
                             a.stream>>>(xdt, dA, Bm, Cm, ws,
                                         static_cast<float*>(a.y), d, hpb);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16: the tensor-core kernels
template <int KP, int KN>
int run_bf16(const Args& a) {
  const Shape& d = a.d;
  float* ws = static_cast<float*>(a.ws);
  float* decay = ws + static_cast<int64_t>(a.B) * d.H * d.nT * d.N * d.P;
  const bf16* xdt = static_cast<const bf16*>(a.xdt);
  const float* dA = static_cast<const float*>(a.dA);
  const bf16* Bm = static_cast<const bf16*>(a.Bm);
  const bf16* Cm = static_cast<const bf16*>(a.Cm);

  const size_t s1 = TcSmem<KP, KN>::kState;
  int err = set_smem(chunk_state_tc_kernel<KP, KN>, s1);
  if (err) return err;
  chunk_state_tc_kernel<KP, KN><<<dim3(d.nT, d.H, a.B), kThreads, s1,
                                  a.stream>>>(xdt, dA, Bm, ws, decay, d);
  if ((err = static_cast<int>(cudaGetLastError())) || a.stages < 2)
    return err;
  if ((err = state_pass(a, ws, decay)) || a.stages < 3) return err;
  const int hpb = heads_per_block(d);
  const size_t s3 = TcSmem<KP, KN>::kOut;
  if ((err = set_smem(chunk_out_tc_kernel<KP, KN>, s3))) return err;
  chunk_out_tc_kernel<KP, KN><<<dim3(d.nT, d.H / hpb, a.B), kTcOutThreads,
                                s3, a.stream>>>(xdt, dA, Bm, Cm, ws,
                                                static_cast<bf16*>(a.y), d,
                                                hpb);
  return static_cast<int>(cudaGetLastError());
}

int64_t tiles(int64_t S, int64_t chunk) {
  const int64_t tq = chunk < kT ? chunk : kT;
  return (S + tq - 1) / tq;
}

int launch(bool is_bf16, const void* xdt, const void* dA, const void* Bm,
           const void* Cm, void* y, void* st, void* ws, int64_t B, int64_t H,
           int64_t G, int64_t S, int64_t P, int64_t N, int64_t chunk,
           int stages, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || S <= 0 || S > INT32_MAX / kMaxPN ||
      chunk <= 0 || S % chunk != 0 || P <= 0 || P > kMaxPN || N <= 0 ||
      N > kMaxPN || B > 65535 || H > 65535 || B * H > 65535 || stages < 1 ||
      stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape d{static_cast<int>(H), static_cast<int>(G), static_cast<int>(S),
                static_cast<int>(P), static_cast<int>(N),
                static_cast<int>(chunk < kT ? chunk : kT),
                static_cast<int>(tiles(S, chunk))};
  const Args a{xdt, dA, Bm, Cm, y, st, ws, static_cast<int>(B), stages, d,
               static_cast<cudaStream_t>(stream)};
  const bool main_shape = P == 64 && N == 128;
  if (is_bf16) return main_shape ? run_bf16<64, 128>(a) : run_bf16<128, 128>(a);
  return main_shape ? run_f32<64, 128>(a) : run_f32<128, 128>(a);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// float32 elements of the workspace the entry points need at this shape
int64_t ssd_scan_workspace_floats(int64_t B, int64_t H, int64_t S, int64_t P,
                                  int64_t N, int64_t chunk) {
  if (chunk <= 0) return 0;
  return B * H * tiles(S, chunk) * (N * P + 1);
}

// xdt (B, H, S, P), B/C (B, G, S, N) in one type, dA (B, H, S) float32 ->
// y (B, H, S, P) in that type, st (B, H, P, N) float32; all contiguous.
// ws: ssd_scan_workspace_floats(...) float32 elements of scratch.
// stages: 3 runs the scan; 1 or 2 stop after that stage and leave its
// result in ws (the per-tile states, then the states entering each tile)
// and, after 2, the final state in st, for tests of the stages.
int ssd_scan_f32(const void* xdt, const void* dA, const void* Bm,
                 const void* Cm, void* y, void* st, void* ws, int64_t B,
                 int64_t H, int64_t G, int64_t S, int64_t P, int64_t N,
                 int64_t chunk, int stages, void* stream) {
  return launch(false, xdt, dA, Bm, Cm, y, st, ws, B, H, G, S, P, N, chunk,
                stages, stream);
}

int ssd_scan_bf16(const void* xdt, const void* dA, const void* Bm,
                  const void* Cm, void* y, void* st, void* ws, int64_t B,
                  int64_t H, int64_t G, int64_t S, int64_t P, int64_t N,
                  int64_t chunk, int stages, void* stream) {
  return launch(true, xdt, dA, Bm, Cm, y, st, ws, B, H, G, S, P, N, chunk,
                stages, stream);
}

}  // extern "C"
