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
// float32: `flash_f32_kernel`, the same shape on the tensor cores in
// 3xTF32, the split that CUTLASS calls "fast accurate float32".  Each
// float32 operand x is split into big = tf32(x) and small = tf32(x - big),
// both rounded to nearest (ties away, as `cvt.rna.tf32.f32` rounds; the
// mma's own truncation of the low 13 bits would keep about 19 bits), and
// each product a b is computed as small_a big_b + big_a small_b + big_a
// big_b by three `mma.sync.m16n8k8` TF32 products with float32
// accumulators.  That keeps about 22 bits of every operand: float32
// accuracy, whatever `torch.backends.cuda.matmul.allow_tf32` says (the
// kernel never reads it).
//
//   * one block of 8 warps owns one (b, h, 128-row query tile), 16 rows a
//     warp (4 warps and 64 rows above Dh 128, where Q takes shared memory
//     too); K and V stream through a two-stage ring of 16-byte
//     `cp.async` copies (zero-filled past Sk) with rows padded to Dh + 4
//     floats, so the scalar fragment loads of K (key g, column t4) and of V
//     (keys 2 t4 and 2 t4 + 1, column g) fall on 32 distinct banks for
//     every Dh (Dh + 4 is 4 or 20 mod 32);
//   * each landed tile is split once by the whole block: big overwrites the
//     raw value in the ring, small goes to a one-stage buffer beside it, so
//     a warp reads its B fragments ready-made (four 32-bit loads for three
//     products) instead of splitting every value once a warp; 8 warps
//     sharing each split tile ran faster than 4 at the model shapes;
//   * up to Dh 112, Q's A fragments are read straight from device memory
//     and split once per block into registers; above it Q sits in shared
//     memory and its fragments are split at every step;
//   * the tensor cores' float32 sum drops low bits of a large accumulator,
//     which over a 2048-key row costs several times plain float32's error.
//     So the scores keep the two cross products in an accumulator of their
//     own (the score's accumulator takes one product a step), and P V sums
//     each 8-key step's three products in a fresh accumulator that a
//     float32 add folds into the output;
//   * P stays in registers: the m16n8 score fragment holds keys (2 t4,
//     2 t4 + 1) where the m16n8k8 A fragment wants k-indices (t4, t4 + 4),
//     so key 2 t4 is read as k-index t4 and key 2 t4 + 1 as t4 + 4, and V's
//     B fragment is read in the same permuted key order (a product's k
//     order is free).  P is split into big and small like every operand:
//     it is float32 in the reference and stays float32-accurate here;
//   * the softmax (with `ex2.approx.ftz`), the masking and the schedule are
//     the bfloat16 instance's; the output is acc / max(l, 1e-30), a true
//     division.
//
//   What bounds it: operations.  Three TF32 products for each float32 one
//   at the card's dense TF32 rate of 495 TFLOP/s, i.e. 3 x 4 Dh per visible
//   (query, key) pair at 495 TFLOP/s: 0.391 ms at minicpm3-4b's MLA
//   prefill (B 2, H 40, S 2048, Dh 96, causal), 0.365 ms at zamba2-7b's
//   (2, 32, 32, 2048, 2048, 112), 0.0586 ms at smollm-135m's.  The same
//   work on the CUDA cores in float32 (67 TFLOP/s) would take 0.962, 0.898
//   and 0.144 ms.  `mma.sync` does not reach the 495 TFLOP/s that `wgmma`
//   does; TF32 `wgmma` wants both operands K-major, so V would need a
//   transposed copy (`ldmatrix.trans` moves 16-bit elements only).
//
//   Per head dim (ptxas's registers and spill-store bytes a thread, and the
//   blocks an SM holds, on an H100 with CUDA 12.8):
//     Dh   warps  key tile  Q fragments    shared memory  registers  blocks
//     16   8      64        registers       30 KB         128 / 4    2
//     32   8      64        registers       54 KB         174 / 0    1
//     64   8      64        registers      102 KB         255 / 68   1
//     96   8      64        registers      150 KB         255 / 176  1
//     112  8      32        registers       87 KB         255 / 116  1
//     128  8      32        shared memory  165 KB         177 / 0    1
//     192  4      32        shared memory  196 KB         255 / 144  1
//     256  4      16        shared memory  163 KB         255 / 696  1
//   With 8 warps at up to 255 registers a thread, one block fills an SM's
//   register file, so the key tile is sized by shared memory and by what
//   ran faster (64 keys at Dh 96, 32 at Dh 112).  chip_smoke.py prints
//   ptxas's report of every instance and each one's dynamic shared memory
//   and blocks an SM holds (`flash_attention_resources`).
//
// Both are built for Dh 16 (the reduced test configs), 32, 64, 96, 112
// (zamba2), 128, 192 and 256.  Given a non-null `lse`, either instance
// also writes each row's log-sum-exp in its epilogue, for the backward
// (flash_attention_bwd.cu); the inference path passes null.  Dynamic
// shared memory above 48 KB is set with cudaFuncSetAttribute.  Each entry
// point issues one launch.  The C entry
// points return the CUDA error code of the launch so the Python wrapper
// raises on a refused launch; the kernel allocates nothing.  Both
// instances read q, k, v in 16-byte pieces: their base addresses must be
// 16-byte aligned (the wrapper sees to it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;        // query rows per block (4 warps x 16)
constexpr float kNegInf = -1e30f;

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

// rows [row0, row0 + ROWS) of a (rows, D) matrix into shared memory with
// rows of LD elements, in 16-byte pieces; rows at or past `total` are zero
template <int D, int ROWS, int LD, int NT = 128, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int total, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPieces = D / kPer;                       // pieces a row
  for (int e = tid; e < ROWS * kPieces; e += NT) {
    const int r = e / kPieces, c = e % kPieces;
    const bool in = row0 + r < total;
    const T* g =
        src + static_cast<int64_t>(in ? row0 + r : 0) * D + c * kPer;
    cp_async16(smem_addr(dst + r * LD + c * kPer), g, in);
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

// the natural log-sum-exp of a lane's two rows' scaled scores, from the
// running max m (log2 domain) and the summed l: ln(2^m l) = (m + log2 l)
// ln 2.  The four lanes of a row hold the same m and l; lane t4 0 writes.
__device__ __forceinline__ void write_lse(float* lse, int row0, int Sq,
                                          int t4, float m0, float l0,
                                          float m1, float l1) {
  constexpr float kLn2 = 0.6931471805599453f;
  if (t4 != 0) return;
  if (row0 < Sq) lse[row0] = (m0 + log2f(l0)) * kLn2;
  if (row0 + 8 < Sq) lse[row0 + 8] = (m1 + log2f(l1)) * kLn2;
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Hkv, int Sq,
                      int Sk, int causal, float scale_log2) {
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
  if (lse != nullptr) write_lse(lse + static_cast<int64_t>(b * H + h) * Sq,
                                row0, Sq, t4, m0, l0, m1, l1);
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

// ------------------------------------------------ float32, 3xTF32 tensor cores
template <int D>
struct F32 {
  static constexpr int kWarps = D <= 128 ? 8 : 4;  // 16 query rows a warp
  static constexpr int kRows = 16 * kWarps;        // query rows a block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = D <= 96 ? 64 : D <= 192 ? 32 : 16;  // keys a tile
  static constexpr int kLd = D + 4;               // padded row, floats
  static constexpr bool kQInRegs = D <= 112;      // split Q held in registers
  // K and V: two stages of tiles (split in place to their big halves) and
  // one of small halves; Q's rows above Dh 112
  static constexpr size_t kBytes =
      sizeof(float) * static_cast<size_t>(kLd) *
      ((kQInRegs ? 0 : kRows) + 6 * kBK);
};

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
// from zero: the rounding of `cvt.rna.tf32.f32`, identical for every finite
// x, in an integer add and a mask (ptxas expands the conversion into a
// compare, the add, the mask and a select)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + what neither keeps (about 2^-22 of x), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// 2^x; results below 2^-126 flush to zero, which a probability may
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// c += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two cross terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

template <int D>
__global__ void __launch_bounds__(F32<D>::kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int causal, float scale_log2) {
  using C = F32<D>;
  constexpr int BK = C::kBK, LD = C::kLd, BQ = C::kRows, NT = C::kThreads;
  constexpr int KD = D / 8;    // 8-wide steps over the head dim
  constexpr int NS = BK / 8;   // 8-key score tiles, and 8-key steps of P V
  constexpr int NO = D / 8;    // 8-wide output tiles
  constexpr int KQ = C::kQInRegs ? KD : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // two stages of BK rows
  float* Vs = Ks + 2 * BK * LD;                    // two stages of BK rows
  float* Kss = Vs + 2 * BK * LD;                   // small halves, one stage
  float* Vss = Kss + BK * LD;
  float* Qs = Vss + BK * LD;                       // BQ rows, above Dh 112

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row and column
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int offset = Sk - Sq;

  const float* qb = q + static_cast<int64_t>(b * H + h) * Sq * D;
  const float* kb = k + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  const float* vb = v + static_cast<int64_t>(b * Hkv + hk) * Sk * D;
  float* ob = o + static_cast<int64_t>(b * H + h) * Sq * D;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_k = min(q0 + BQ, Sq) - 1 + offset;
    n_tiles = last_k < 0 ? 0 : min(n_tiles, last_k / BK + 1);
  }

  if (!C::kQInRegs) load_rows<D, BQ, LD, NT>(Qs, qb, q0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<D, BK, LD, NT>(Ks, kb, 0, Sk, tid);
    load_rows<D, BK, LD, NT>(Vs, vb, 0, Sk, tid);
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

  // Q's A fragments (a0 row g col t4, a1 row g + 8, a2 col t4 + 4, a3
  // both), split once: straight from device memory up to Dh 112
  uint32_t qbig[KQ][4], qsmall[KQ][4];
  if (C::kQInRegs) {
    const float* r0 = qb + static_cast<int64_t>(row0) * D + t4;
    const float* r1 = r0 + 8 * D;
    const bool in0 = row0 < Sq, in1 = row0 + 8 < Sq;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      split_tf32(in0 ? r0[kk * 8] : 0.f, qbig[kk][0], qsmall[kk][0]);
      split_tf32(in1 ? r1[kk * 8] : 0.f, qbig[kk][1], qsmall[kk][1]);
      split_tf32(in0 ? r0[kk * 8 + 4] : 0.f, qbig[kk][2], qsmall[kk][2]);
      split_tf32(in1 ? r1[kk * 8 + 4] : 0.f, qbig[kk][3], qsmall[kk][3]);
    }
  }
  const float* q_frag = Qs + (warp * 16 + g) * LD + t4;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows<D, BK, LD, NT>(Ks + (buf ^ 1) * BK * LD, kb, (t + 1) * BK, Sk,
                           tid);
      load_rows<D, BK, LD, NT>(Vs + (buf ^ 1) * BK * LD, vb, (t + 1) * BK, Sk,
                           tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; tile t - 1's small halves consumed
    float* Kb = Ks + buf * BK * LD;
    float* Vb = Vs + buf * BK * LD;
    {
      // split the tile once for all four warps: big over the raw value,
      // small beside it
      constexpr int kPieces = D / 4;
      for (int e = tid; e < 2 * BK * kPieces; e += NT) {
        const bool is_v = e >= BK * kPieces;
        const int rem = is_v ? e - BK * kPieces : e;
        const int off = (rem / kPieces) * LD + (rem % kPieces) * 4;
        float* raw = (is_v ? Vb : Kb) + off;
        const float4 x = *reinterpret_cast<const float4*>(raw);
        uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
        split_tf32(x.x, b0, s0);
        split_tf32(x.y, b1, s1);
        split_tf32(x.z, b2, s2);
        split_tf32(x.w, b3, s3);
        *reinterpret_cast<float4*>(raw) =
            make_float4(__uint_as_float(b0), __uint_as_float(b1),
                        __uint_as_float(b2), __uint_as_float(b3));
        *reinterpret_cast<float4*>((is_v ? Vss : Kss) + off) =
            make_float4(__uint_as_float(s0), __uint_as_float(s1),
                        __uint_as_float(s2), __uint_as_float(s3));
      }
    }
    __syncthreads();  // the split is complete

    // S = Q K^T, 16 rows x BK keys a warp; K's B fragment of an 8-key tile
    // j: b0 key g col t4, b1 key g col t4 + 4.  The cross terms go to an
    // accumulator of their own, so the score's accumulator takes one
    // product a step: the tensor cores' sum drops low bits of a large one
    float s[NS][4], sx[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sx[j][e] = 0.f;
    const int k_off = g * LD + t4;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t(&ab)[4] = qbig[C::kQInRegs ? kk : 0];
      uint32_t(&as)[4] = qsmall[C::kQInRegs ? kk : 0];
      if (!C::kQInRegs) {
        const float* r = q_frag + kk * 8;
        split_tf32(r[0], ab[0], as[0]);
        split_tf32(r[8 * LD], ab[1], as[1]);
        split_tf32(r[4], ab[2], as[2]);
        split_tf32(r[8 * LD + 4], ab[3], as[3]);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int i = k_off + j * 8 * LD + kk * 8;
        const uint32_t bb0 = __float_as_uint(Kb[i]),
                       bb1 = __float_as_uint(Kb[i + 4]),
                       bs0 = __float_as_uint(Kss[i]),
                       bs1 = __float_as_uint(Kss[i + 4]);
        mma_tf32(sx[j], as, bb0, bb1);
        mma_tf32(sx[j], ab, bs0, bs1);
        mma_tf32(s[j], ab, bb0, bb1);
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
        float x = (s[j][e] + sx[j][e]) * scale_log2;
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
    const float corr0 = exp2_ftz(m0 - mn0), corr1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2_ftz(s[j][0] - mn0);
      s[j][1] = exp2_ftz(s[j][1] - mn0);
      s[j][2] = exp2_ftz(s[j][2] - mn1);
      s[j][3] = exp2_ftz(s[j][3] - mn1);
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

    // O += P V over 8-key steps.  P's A fragment straight from the score
    // accumulators, key 2 t4 as k-index t4 and key 2 t4 + 1 as t4 + 4; V's
    // B fragment in the same key order: b0 key 2 t4, b1 key 2 t4 + 1, col
    // g.  Each step's three products are summed alone and added to the
    // output with a float32 add, for the same reason as above
    const int v_off = 2 * t4 * LD + g;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t pb[4], ps[4];
      split_tf32(s[kk][0], pb[0], ps[0]);
      split_tf32(s[kk][2], pb[1], ps[1]);
      split_tf32(s[kk][1], pb[2], ps[2]);
      split_tf32(s[kk][3], pb[3], ps[3]);
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const int i = v_off + kk * 8 * LD + c * 8;
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(w, pb, ps, __float_as_uint(Vb[i]),
                   __float_as_uint(Vb[i + LD]), __float_as_uint(Vss[i]),
                   __float_as_uint(Vss[i + LD]));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] += w[e];
      }
    }
    __syncthreads();  // this stage is consumed; tile t + 2 may land in it
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse != nullptr) write_lse(lse + static_cast<int64_t>(b * H + h) * Sq,
                                row0, Sq, t4, m0, l0, m1, l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = c * 8 + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row0) * D + col) =
          make_float2(acc[c][0] / d0, acc[c][1] / d0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row0 + 8) * D +
                                 col) =
          make_float2(acc[c][2] / d1, acc[c][3] / d1);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               cudaStream_t stream) {
  const size_t smem = F32<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + F32<D>::kRows - 1) / F32<D>::kRows);
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  flash_f32_kernel<D><<<grid, F32<D>::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Hkv, Sq,
      Sk, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
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
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, Hkv, Sq,
      Sk, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool is_bf16, const void* q, const void* k, const void* v,
           void* o, float* lse, int B, int H, int Hkv, int Sq, int Sk,
           int causal, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                  stream)
                 : launch_f32<D>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, causal,
                                 stream);
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
             void* o, void* lse, int64_t B, int64_t H, int64_t Hkv,
             int64_t Sq, int64_t Sk, int64_t Dh, int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk);
  return with_head_dim(Dh, [&](auto d) {
    return launch<decltype(d)::value>(is_bf16, q, k, v, o,
                                      static_cast<float*>(lse), b, h, hkv,
                                      sq, sk, causal, s);
  });
}

// dynamic shared memory, registers, local (spill) bytes and resident
// blocks an SM of the current device holds, of one instance
template <int D>
int resources(bool is_bf16, int64_t* out) {
  const void* fn =
      is_bf16 ? reinterpret_cast<const void*>(flash_bf16_kernel<D>)
              : reinterpret_cast<const void*>(flash_f32_kernel<D>);
  const size_t smem = is_bf16 ? Tc<D>::kBytes : F32<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, is_bf16 ? Tc<D>::kThreads : F32<D>::kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int64_t>(smem);
  out[1] = attr.numRegs;
  out[2] = static_cast<int64_t>(attr.localSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) -> o (B, H, Sq, Dh), contiguous,
// one type.  causal: 0 or 1.  lse: null, or float32 (B, H, Sq) that
// receives each row's natural log-sum-exp of its scaled, masked scores
// (what the backward in flash_attention_bwd.cu recomputes P from).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int64_t B, int64_t H, int64_t Hkv,
                        int64_t Sq, int64_t Sk, int64_t Dh, int causal,
                        void* stream) {
  return dispatch(false, q, k, v, o, lse, B, H, Hkv, Sq, Sk, Dh, causal,
                  stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int64_t B, int64_t H,
                         int64_t Hkv, int64_t Sq, int64_t Sk, int64_t Dh,
                         int causal, void* stream) {
  return dispatch(true, q, k, v, o, lse, B, H, Hkv, Sq, Sk, Dh, causal,
                  stream);
}

// out[4]: dynamic shared memory bytes, registers a thread, local bytes a
// thread and resident blocks an SM of the instance (is_bf16, Dh)
int flash_attention_resources(int is_bf16, int64_t Dh, int64_t* out) {
  return with_head_dim(Dh, [&](auto d) {
    return resources<decltype(d)::value>(is_bf16 != 0, out);
  });
}

}  // extern "C"
