// Flash attention (forward) on Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention_tpu`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`):
//
//   o[b, h] = softmax(q[b, h] k[b, h / g]^T / sqrt(Dh) + mask) v[b, h / g]
//
// for q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh), g = H / Hkv (GQA read through
// the head index; no repeated K/V is materialised).  The causal mask is
// end-aligned, key kpos visible to query qpos when kpos <= qpos + (Sk - Sq);
// keys at kpos >= Sk are masked.  Masked scores take the reference's finite
// -1e30, not -inf, and the running max starts there too, so the kernel
// computes what the reference's blocked algorithm computes (a row that sees
// no key in a visited tile keeps that algorithm's convention).  The output
// is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it: operations.  At smollm-135m's shape (B 2, H 9, S 2048,
// Dh 64, causal) it does 2 * 2 * Dh operations per visible (query, key)
// pair, about 9.7 GFLOP, against 12.6 MB of q, k, v and o in bfloat16:
// 0.0098 ms at the card's dense bfloat16 tensor-core rate.  Two instances:
//
// bfloat16: `flash_bf16_kernel`, FlashAttention-2 in shape, on the tensor
// cores.  One block of 4 warps owns one (b, h, 64-row query tile), 16 rows
// a warp, and walks the key tiles (64 keys; 32 at Dh 192 and 256):
//
//   * Q, K and V stay bfloat16 in shared memory.  Rows are padded by 8
//     elements (16 bytes), so the eight row addresses of every `ldmatrix`
//     fall in eight different 16-byte bank groups for every Dh;
//   * K and V tiles stream through a two-stage ring filled with 16-byte
//     `cp.async` copies (rows past Sk are zero-filled by the copy), so the
//     next tile's loads are in flight during this tile's products;
//   * S = Q K^T and O += P V are `mma.sync.m16n8k16` (bfloat16 operands,
//     float32 accumulators in registers); K fragments come from `ldmatrix`,
//     V fragments from `ldmatrix.trans`;
//   * P never leaves registers: the score accumulators of two 8-key tiles
//     are exactly the A fragment of one 16-key step of P V, so they are
//     packed to bfloat16 pairs in place.  Rounding P to bfloat16 is this
//     instance's one departure from the reference, whose P is float32;
//   * the softmax runs in the log2 domain (exp2 of scores pre-scaled by
//     log2(e) / sqrt(Dh)); a row's max is a shuffle over the four lanes that
//     hold it; the row sums stay per lane and are reduced once at the end;
//     only tiles that cross the causal diagonal or Sk are masked;
//   * key tiles wholly above the causal diagonal are never visited.  The
//     query tile is the grid's slowest dimension, counted from the last, so
//     the tiles with the most work of every (b, h) are scheduled first and
//     the light ones fill the tail.
//
//   Per head dim (threads hold 16 rows / 4 lanes = 4 row halves):
//     Dh   key tile  Q fragments     acc regs  shared memory
//     16   64        registers (4)    8        15 KB
//     32   64        registers (8)   16        25 KB
//     64   64        registers (16)  32        45 KB
//     96   64        registers (24)  48        65 KB
//     112  64        registers (28)  56        75 KB
//     128  64        registers (32)  64        85 KB
//     192  32        shared memory   96        75 KB
//     256  32        shared memory  128        99 KB
//   Above Dh 128 the Q fragments are reloaded from shared memory at every
//   step and the key tile is halved, so the 128 float32 accumulators of
//   Dh 256 leave room for the scores.  ptxas's report of each instance is
//   printed by chip_smoke.py.
//
// float32: `flash_fwd_kernel`, unchanged since it was first written, on the
// CUDA cores in full float32 (no TF32): one block of 256 threads (a 16 x 16
// grid, 4 query rows and Dh / 16 output columns a thread) per (b, h, 64-row
// query tile), the query tile and per step one key and one value tile
// staged in shared memory as float32 with rows of Dh + 1 floats, the
// probabilities through shared memory; its roof is the card's float32 rate.
// Shared memory: (64 (Dh+1) + 64 (Dh+1) + 64 Dh + 64 * 65) floats, 66 KB at
// Dh 64, 101 KB at Dh 112 and 209 KB at Dh 256.
//
// Both are built for Dh 16 (the reduced test configs), 32, 64, 96, 112
// (zamba2), 128, 192 and 256.  Dynamic shared memory above 48 KB is set with
// cudaFuncSetAttribute.  Each entry point issues one launch.  The C entry
// points return the CUDA error code of the launch so the Python wrapper
// raises on a refused launch; the kernel allocates nothing.  The bfloat16
// instance reads q, k, v in 16-byte pieces: their base addresses must be
// 16-byte aligned (the wrapper sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile (float32)
constexpr int kThreads = 256;  // a 16 x 16 thread grid (float32)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * (D + 1);
  static constexpr int kK = kBK * (D + 1);
  static constexpr int kV = kBK * D;
  static constexpr int kP = kBQ * (kBK + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Hkv, int Sq, int Sk, int causal, float scale) {
  static_assert(D % 16 == 0, "Dh must be a multiple of 16");
  constexpr int kC = kBK / 16;  // score columns per thread
  constexpr int kO = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::kQ;
  float* Vs = Ks + Smem<D>::kK;
  float* Ps = Vs + Smem<D>::kV;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;

  const T* qb = q + static_cast<int64_t>(b * H + h) * Sq * D;
  const T* kb = k + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  const T* vb = v + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  T* ob = o + static_cast<int64_t>(b * H + h) * Sq * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * (D + 1) + c] =
        q0 + r < Sq ? to_f32(qb[static_cast<int64_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][kO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kO; ++c) acc[i][c] = 0.f;
  }

  // key tiles this query tile sees: all of them, or (causal) up to the one
  // holding the last visible key of its last real row
  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_k = min(q0 + kBQ, Sq) - 1 + offset;
    n_tiles = last_k < 0 ? 0 : min(n_tiles, last_k / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Sk;
      const int64_t g = static_cast<int64_t>(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[g]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][kC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kC; ++j) bk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kO; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P of this tile is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[kO];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kO; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kO; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kO; ++c)
      store(ob + static_cast<int64_t>(row) * D + tx + 16 * c,
            acc[i][c] / denom);
  }
}


// ------------------------------------------------ bfloat16, tensor cores
using bf16 = __nv_bfloat16;

template <int D>
struct Tc {
  static constexpr int kThreads = 128;             // 4 warps x 16 rows
  static constexpr int kBK = D <= 128 ? 64 : 32;   // keys per tile
  static constexpr int kLd = D + 8;                // padded row, elements
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t kBytes =
      sizeof(bf16) * static_cast<size_t>(kLd) * (kBQ + 4 * kBK);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with !valid the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 out
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

// rows [row0, row0 + ROWS) of a (rows, D) bfloat16 matrix into shared
// memory with rows of LD elements; rows at or past `total` are zero
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int total, int tid) {
  constexpr int kPieces = D / 8;  // 16-byte pieces a row
  for (int e = tid; e < ROWS * kPieces; e += 128) {
    const int r = e / kPieces, c = e % kPieces;
    const bool in = row0 + r < total;
    const bf16* g = src + static_cast<int64_t>(in ? row0 + r : 0) * D + c * 8;
    cp_async16(smem_addr(dst + r * LD + c * 8), g, in);
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int H, int Hkv, int Sq, int Sk, int causal,
                      float scale_log2) {
  using C = Tc<D>;
  constexpr int BK = C::kBK, LD = C::kLd;
  constexpr int KD = D / 16;   // 16-wide steps over the head dim
  constexpr int NS = BK / 8;   // 8-key score tiles
  constexpr int NO = D / 8;    // 8-wide output tiles
  constexpr int KQ = C::kQInRegs ? KD : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * LD;      // two stages of BK rows
  bf16* Vs = Ks + 2 * BK * LD;   // two stages of BK rows

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row and column
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;

  const bf16* qb = q + static_cast<int64_t>(b * H + h) * Sq * D;
  const bf16* kb = k + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  const bf16* vb = v + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  bf16* ob = o + static_cast<int64_t>(b * H + h) * Sq * D;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_k = min(q0 + kBQ, Sq) - 1 + offset;
    n_tiles = last_k < 0 ? 0 : min(n_tiles, last_k / BK + 1);
  }

  load_rows<D, kBQ, LD>(Qs, qb, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<D, BK, LD>(Ks, kb, 0, Sk, tid);
    load_rows<D, BK, LD>(Vs, vb, 0, Sk, tid);
  }
  cp_async_commit();

  // this lane's two rows (g and g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + g;
  const int qpos0 = row0 + offset, qpos1 = row0 + 8 + offset;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  uint32_t qf[KQ][4];
  // the lane's ldmatrix row of the warp's Q rows, for each 16-wide step
  const uint32_t q_addr =
      smem_addr(Qs + (warp * 16 + lr + (lm & 1) * 8) * LD + (lm >> 1) * 8);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows<D, BK, LD>(Ks + (buf ^ 1) * BK * LD, kb, (t + 1) * BK, Sk,
                           tid);
      load_rows<D, BK, LD>(Vs + (buf ^ 1) * BK * LD, vb, (t + 1) * BK, Sk,
                           tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (C::kQInRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldsm_x4(q_addr + kk * 32, qf[kk][0], qf[kk][1], qf[kk][2],
                qf[kk][3]);
    }
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;

    // S = Q K^T, 16 rows x BK keys a warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t k_addr =
        smem_addr(Kb + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if (C::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[C::kQInRegs ? kk : 0][e];
      } else {
        ldsm_x4(q_addr + kk * 32, a[0], a[1], a[2], a[3]);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_addr + (j * 8 * LD + kk * 16) * 2, b0, b1, b2, b3);
        mma_bf16(s[j], a, b0, b1);
        mma_bf16(s[j + 1], a, b2, b3);
      }
    }

    // online softmax in the log2 domain
    const int k0 = t * BK;
    const bool edge =
        k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + offset);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      acc[c][0] *= corr0;
      acc[c][1] *= corr0;
      acc[c][2] *= corr1;
      acc[c][3] *= corr1;
    }

    // O += P V: P's A fragments straight from the score accumulators
    const uint32_t v_addr =
        smem_addr(Vb + ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int c = 0; c < NO; c += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(v_addr + (kk * 16 * LD + c * 8) * 2, b0, b1, b2, b3);
        mma_bf16(acc[c], a, b0, b1);
        mma_bf16(acc[c + 1], a, b2, b3);
      }
    }
    __syncthreads();  // this stage is consumed; tile t + 2 may land in it
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = c * 8 + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(row0) * D +
                                         col) =
          __floats2bfloat162_rn(acc[c][0] * inv0, acc[c][1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(row0 + 8) * D + col) =
          __floats2bfloat162_rn(acc[c][2] * inv1, acc[c][3] * inv1);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, int causal,
               cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Sk,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Hkv, int Sq, int Sk, int causal,
                cudaStream_t stream) {
  const size_t smem = Tc<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  flash_bf16_kernel<D><<<grid, Tc<D>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hkv, Sq, Sk,
      causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool is_bf16, const void* q, const void* k, const void* v,
           void* o, int B, int H, int Hkv, int Sq, int Sk, int causal,
           cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                  stream)
                 : launch_f32<D>(q, k, v, o, B, H, Hkv, Sq, Sk, causal,
                                 stream);
}

int dispatch(bool is_bf16, const void* q, const void* k, const void* v,
             void* o, int64_t B, int64_t H, int64_t Hkv, int64_t Sq,
             int64_t Sk, int64_t Dh, int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk);
  switch (Dh) {
    case 16: return launch<16>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 32: return launch<32>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 64: return launch<64>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 96: return launch<96>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 112: return launch<112>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 128: return launch<128>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 192: return launch<192>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 256: return launch<256>(is_bf16, q, k, v, o, b, h, hkv, sq, sk, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) -> o (B, H, Sq, Dh), contiguous,
// one type.  causal: 0 or 1.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t H, int64_t Hkv, int64_t Sq,
                        int64_t Sk, int64_t Dh, int causal, void* stream) {
  return dispatch(false, q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int64_t B, int64_t H, int64_t Hkv,
                         int64_t Sq, int64_t Sk, int64_t Dh, int causal,
                         void* stream) {
  return dispatch(true, q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal, stream);
}

}  // extern "C"
