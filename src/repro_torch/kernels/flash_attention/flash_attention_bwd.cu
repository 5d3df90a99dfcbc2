// Flash attention backward on Hopper's tensor cores.
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
// lse log2(e)), P = e / l with l = sum_j e.  Given dO, two launches:
//
//   1. dQ, grid (head, B, query tile), the query tiles counted from the
//      last so the heaviest are scheduled first: a block keeps its 64 rows
//      of Q and dO in shared memory and sweeps its KV tiles (up to its
//      causal diagonal) twice.  The first sweep forms each row's
//      l = sum_j e_j and D = sum_j e_j dP_j / l (dP = dO V^T) and stores
//      (1 / l, D) for launch 2; the second forms
//        S = Q K^T,  P = e / l,  dP = dO V^T,  dS = P o (dP - D),
//        dQ += dS K / sqrt(Dh).
//      D is the softmax backward's sum_j P_j dP_j, which equals dO . o;
//      formed from the backward's own P and dP it makes sum_j dS_j vanish
//      to rounding, as the plain version's autograd does: from dO . o (the
//      forward's rounded o) it left about 5e-7 of the largest dQ in rows
//      whose dQ is 0, 2.4x the plain version's error.  Recomputing l also
//      absorbs the rounding of the saved lse.  Both instances keep this
//      source of l and D: one design for both types, no accuracy to trade;
//   2. dK/dV, grid (KV head, B, KV tile), the first (heaviest) tiles first:
//      a block keeps its K and V tile and walks every query tile of every
//      query head of its KV head's group (the heads in order, then the
//      tiles in order, from the first tile that sees its keys):
//        S^T = K Q^T,  P^T,  dP^T = V dO^T,  dS^T = P^T o (dP^T - D),
//        dV += P^T dO,  dK += dS^T Q / sqrt(Dh).
//      The GQA sum over a group's heads is this loop: no atomics, and two
//      runs give the same bits, which the bit-for-bit resume of training
//      needs.
//
// Nine products of 2 Dh operations a visible (query, key) pair (S and dP
// three times) against the five the gradient needs; the price of bitwise
// repeatable sums without atomics.
//
// Warp layout (both instances, both kernels).  4 warps; a warp owns 16 rows
// of the M side of every product: 16 query rows in dQ, 16 keys in dK/dV,
// where the keys are the M rows so that S^T and dP^T come out of the tensor
// cores in the A-fragment layout of the next product: P^T and dS^T never
// leave registers (the m16n8 accumulators of two 8-column tiles are one A
// fragment, as the forward's P is).  Operands are padded rows in shared
// memory; the streamed tiles (K and V in dQ; Q, dO and the rows' lse and
// (1 / l, D) in dK/dV) go through a two-stage ring of `cp.async` copies
// (zero-filled past Sq or Sk), so the next tile's loads are in flight
// during this tile's products.  Only tiles that cross the causal diagonal
// or an edge are masked; tiles wholly above the diagonal are never visited.
//
// bfloat16: `mma.sync.m16n8k16` (bfloat16 operands, float32 accumulators).
//   Rows padded by 8 elements, so every `ldmatrix` reads eight distinct
//   16-byte bank groups.  The A fragments of Q and dO (dQ) or K and V
//   (dK/dV) come from `ldmatrix`; B fragments of the transposed products
//   (K, V in dQ; Q, dO in dK/dV) from `ldmatrix`, those of dS K, P^T dO and
//   dS^T Q from `ldmatrix.trans`.  P and dS are carried into their
//   products as bfloat16 pairs, hi = bf16(x) and lo = bf16(x - hi), packed
//   in registers (two products each, lo first): rounded to one bfloat16,
//   as the forward rounds P, they put dQ at 1.6-2.0x the plain version's
//   float64-referenced error (the plain version keeps P and dS in float32)
//   against the 2x rule; as pairs, 1.0x.  Sums stay in the accumulators.
//
// float32: 3xTF32 on `mma.sync.m16n8k8`, the forward's arithmetic.  Every
//   operand x is split into big = tf32_rna(x) and small = tf32_rna(x - big)
//   (`cvt.rna.tf32.f32`'s rounding) and a product is small x big + big x
//   small + big x big: float32 accuracy, whatever `allow_tf32` says.
//   * Each landed tile of the ring is split once by the whole block: big
//     over the raw value, small in a one-stage buffer beside it, so a warp
//     reads its B fragments ready-made.  The A operands that stay for the
//     whole block (Q and dO in dQ, K and V in dK/dV) stay raw and are split
//     in registers at each 8-wide step, shared by every column tile;
//   * the tensor cores' float32 sum truncates toward zero what it drops,
//     so a long chain of products in one accumulator loses accuracy and is
//     biased toward smaller magnitudes; a train step's second AdamW update
//     at lr 1e-2 turns on which small gradients round which way
//     (chip_smoke.py's train/smollm-135m/held-S2048).  So S and dP keep
//     their two cross products in an accumulator of their own and fold
//     big x big into the score by a float32 add every 4 steps (32 of the
//     head dim); dQ, dK and dV sum each 8-wide step's three products in a
//     fresh accumulator; dQ adds each step to its total, dK and dV add a
//     query tile's steps into a tile sum first and the tile sum to the
//     total ((H / Hkv) Sq terms, 12 288 at smollm's 4096 tokens).  On an
//     H100 the chains this replaces (the head dim in one accumulator, a
//     tile's dK and dV in one) put gradients at up to 1.9x the float32
//     plain version's float64-referenced error and that cell's second
//     step at 1.4-2.6x its allowance; these sums keep every gradient
//     within 1.12x (at most 0.84x the plain version's RMS error) and the
//     step at 0.81.  Folding S and dP at every step as well costs 11-24 %
//     more time;
//   * P and dS feed the next product from registers in the forward's
//     permuted k order: column 2 t4 of the m16n8 accumulator is read as
//     k-index t4, column 2 t4 + 1 as t4 + 4, and the B operand's rows in
//     the same order (a product's k order is free);
//   * rows padded to Dh + 4 floats, so the scalar fragment loads (row g,
//     column t4; rows 2 t4 and 2 t4 + 1, column g) fall on 32 distinct
//     banks for every Dh (Dh + 4 is 4 or 20 mod 32).
//
// Tiles per Dh (`Tiles`; dQ: 64 query rows a block; dK/dV: 64 keys a
// block, or 32 where the 16 x Dh dK and dV accumulators of a warp are split
// over two warps by columns, each of the pair computing the same P^T and
// dS^T; "keys": a tile of the dQ ring, "queries": a tile of the dK/dV
// ring) and the shared memory (KB) of dQ / dK/dV:
//   Dh   f32: keys  queries  shared        bf16: keys  queries  shared
//   16        32    32        26 / 26            64    64        18 / 20
//   32        32    32        46 / 47            64    64        31 / 32
//   64        32    32        87 / 88            64    64        55 / 57
//   96        32    16       128 / 90            64    32        80 / 54
//   112       32    16       148 / 104           64    32        92 / 62
//   128       32    32       169 / 170           64    32       104 / 70
//   192       16    32 split 176 / 201           32    32 split 102 / 78
//   256        8    16 split 183 / 167           32    32 split 135 / 102
// ptxas's registers / spill-store bytes a thread on an H100 (dQ, then
// dK/dV):
//   Dh     16     32     64      96      112     128     192     256
//   f32   125/0  128/4  171/0   190/0   255/60  255/44  255/32  255/16
//         132/0  136/0  255/180 255/16  255/84  255/64  255/56  255/4
//   bf16  122/0  128/0  168/0   168/12  170/0   206/0   222/0   255/24
//         120/0  157/0  182/0   214/0   241/0   249/0   231/0   253/0
// Query tiles of 16 ran 10-17 % faster at Dh 96 and 112 (f32).  An SM
// holds one f32 block from Dh 96 up (two dK/dV blocks at Dh 96 and 112),
// two or more below; chip_smoke.py prints ptxas's report of every kernel
// and each one's shared memory and blocks an SM holds
// (`flash_attention_bwd_resources`).
//
// What bounds it: operations.  Five products of 2 Dh operations per visible
// pair are the least the gradient needs, 2.5x the forward's 4 Dh: at
// smollm-135m's B 2 x 4096 (9 heads of 64) 0.586 ms as 3xTF32 at the card's
// 495 TFLOP/s, 0.0244 ms in bfloat16 at 989 TFLOP/s at B 2 x 2048.  This
// design runs nine products (twelve in bfloat16, with the pairs), three
// TF32 ones each in float32.
//
// The entry points take q, k, v and dO contiguous in one type (float32 or
// bfloat16) with 16-byte aligned bases, lse float32, a float32 scratch of
// 2 B H Sq floats for the row statistics, and write dq, dk, dv contiguous
// in the inputs' type.  They return the CUDA error code of the first launch
// that fails, so the Python wrapper raises; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kQRows = 64;     // query rows of a dQ block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
// f32: the 8-wide steps of S's and dP's big x big products summed in a
// fresh accumulator before a float32 add folds them into the score
constexpr int kScoreFold = 4;

template <int D, bool F32>
struct Tiles {
  static constexpr int kLd = F32 ? D + 4 : D + 8;  // padded row, elements
  // dQ: keys a tile of the ring
  static constexpr int kBK =
      F32 ? (D <= 128 ? 32 : D <= 192 ? 16 : 8) : (D <= 128 ? 64 : 32);
  // dK/dV: warps sharing a key group by columns, keys a block, queries a
  // tile of the ring
  static constexpr int kCS = D <= 128 ? 1 : 2;
  static constexpr int kKeys = 16 * (kThreads / 32) / kCS;
  static constexpr int kBQ =
      F32 ? (D <= 64 ? 32 : D <= 112 ? 16 : D <= 192 ? 32 : 16)
          : (D <= 64 ? 64 : 32);
  using T = typename std::conditional<F32, float, bf16>::type;
  // dQ: Q and dO, two stages of K and V tiles, and (f32) one of their small
  // halves
  static constexpr size_t kQBytes =
      sizeof(T) * static_cast<size_t>(kLd) *
      (2 * kQRows + 4 * kBK + (F32 ? 2 * kBK : 0));
  // dK/dV: K and V, two stages of Q and dO tiles and of the rows' (1 / l,
  // D) and lse, and (f32) one stage of small halves
  static constexpr size_t kKvBytes =
      sizeof(T) * static_cast<size_t>(kLd) *
          (2 * kKeys + 4 * kBQ + (F32 ? 2 * kBQ : 0)) +
      2 * kBQ * (sizeof(float2) + sizeof(float));
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4, 8) bytes global -> shared; with !valid the destination is
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
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

// c += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 to nearest, ties away from zero: `cvt.rna.tf32.f32`'s
// rounding, in an integer add and a mask (flash_attention.cu's form)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + what neither keeps (about 2^-22 of x), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// ---------------------------------------------------------- tile copies
// rows [row0, row0 + ROWS) of a (rows, D) matrix into shared memory with
// rows of LD elements, in 16-byte pieces; rows at or past `total` are zero
template <int D, int ROWS, int LD, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int total, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPieces = D / kPer;                       // pieces a row
  for (int e = tid; e < ROWS * kPieces; e += kThreads) {
    const int r = e / kPieces, c = e % kPieces;
    const bool in = row0 + r < total;
    const T* g =
        src + static_cast<int64_t>(in ? row0 + r : 0) * D + c * kPer;
    cp_async16(smem_addr(dst + r * LD + c * kPer), g, in);
  }
}

// ROWS rows of the tiles at a and b split in place into their big halves,
// the small halves to as and bs (same layout)
template <int D, int ROWS, int LD>
__device__ __forceinline__ void split_tiles(float* a, float* as, float* b,
                                            float* bs, int tid) {
  constexpr int kPieces = D / 4;
  for (int e = tid; e < 2 * ROWS * kPieces; e += kThreads) {
    const bool second = e >= ROWS * kPieces;
    const int rem = second ? e - ROWS * kPieces : e;
    const int off = (rem / kPieces) * LD + (rem % kPieces) * 4;
    float* raw = (second ? b : a) + off;
    const float4 x = *reinterpret_cast<const float4*>(raw);
    uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
    split_tf32(x.x, b0, s0);
    split_tf32(x.y, b1, s1);
    split_tf32(x.z, b2, s2);
    split_tf32(x.w, b3, s3);
    *reinterpret_cast<float4*>(raw) =
        make_float4(__uint_as_float(b0), __uint_as_float(b1),
                    __uint_as_float(b2), __uint_as_float(b3));
    *reinterpret_cast<float4*>((second ? bs : as) + off) =
        make_float4(__uint_as_float(s0), __uint_as_float(s1),
                    __uint_as_float(s2), __uint_as_float(s3));
  }
}

// ------------------------------------------------------- warp products
// s[j] = A B_j^T over the head dim, 3xTF32: A the warp's 16 raw rows at
// `a` (split at each 8-wide step; fragment a0 row g col t4, a1 row g + 8,
// a2 col t4 + 4, a3 both), B_j the 8-row tile j of the split tile bb / bs
// (b0 row g col t4, b1 col t4 + 4).  The cross products sum in an
// accumulator of their own; big x big in a fresh one that a float32 add
// folds into s every kScoreFold steps.  Q and dO's small halves times K and
// V's big ones go first, whichever side is A (KV_A: K or V is), so the dQ
// and dK/dV kernels form S and S^T, dP and dP^T bit for bit alike (the
// tensor cores add the same exact products in the same k order)
template <int D, int NT, int LD, bool KV_A>
__device__ __forceinline__ void scores_f32(float (&s)[NT][4], const float* a,
                                           const float* bb, const float* bs,
                                           int g, int t4) {
  constexpr int KD = D / 8;
  float sx[NT][4], sw[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = sx[j][e] = sw[j][e] = 0.f;
  const float* ar = a + g * LD + t4;
  const int b_off = g * LD + t4;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(ar[kk * 8], ab[0], as[0]);
    split_tf32(ar[8 * LD + kk * 8], ab[1], as[1]);
    split_tf32(ar[kk * 8 + 4], ab[2], as[2]);
    split_tf32(ar[8 * LD + kk * 8 + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int i = b_off + j * 8 * LD + kk * 8;
      const uint32_t bb0 = __float_as_uint(bb[i]),
                     bb1 = __float_as_uint(bb[i + 4]),
                     bs0 = __float_as_uint(bs[i]),
                     bs1 = __float_as_uint(bs[i + 4]);
      if (KV_A) {
        mma_tf32(sx[j], ab, bs0, bs1);
        mma_tf32(sx[j], as, bb0, bb1);
      } else {
        mma_tf32(sx[j], as, bb0, bb1);
        mma_tf32(sx[j], ab, bs0, bs1);
      }
      mma_tf32(sw[j], ab, bb0, bb1);
      if ((kk + 1) % kScoreFold == 0 || kk + 1 == KD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += sw[j][e];
          sw[j][e] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += sx[j][e];
}

// acc[c] += P B, 3xTF32, over NK 8-wide k-steps: P's A fragments from its
// m16n8 accumulators p[kk] (column 2 t4 as k-index t4, 2 t4 + 1 as t4 + 4),
// B's rows (the k side, from bb / bs, split) in the same order: b0 row
// 2 t4, b1 row 2 t4 + 1, column g of output tile c.  Each step's three
// products are summed in a fresh accumulator (the tensor cores truncate
// toward zero what a sum drops, so a long chain is biased), added with
// float32 adds to the sum of FOLD steps, which is added to acc
template <int NK, int NO, int LD, int FOLD>
__device__ __forceinline__ void accumulate_f32(float (&acc)[NO][4],
                                               const float (&p)[NK][4],
                                               const float* bb,
                                               const float* bs, int g,
                                               int t4) {
  static_assert(NK % FOLD == 0, "FOLD divides the steps");
  const int off = 2 * t4 * LD + g;
#pragma unroll
  for (int k0 = 0; k0 < NK; k0 += FOLD) {
    uint32_t pb[FOLD][4], ps[FOLD][4];
#pragma unroll
    for (int u = 0; u < FOLD; ++u) {
      split_tf32(p[k0 + u][0], pb[u][0], ps[u][0]);
      split_tf32(p[k0 + u][2], pb[u][1], ps[u][1]);
      split_tf32(p[k0 + u][1], pb[u][2], ps[u][2]);
      split_tf32(p[k0 + u][3], pb[u][3], ps[u][3]);
    }
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        const int i = off + (k0 + u) * 8 * LD + c * 8;
        const uint32_t bb0 = __float_as_uint(bb[i]),
                       bb1 = __float_as_uint(bb[i + LD]),
                       bs0 = __float_as_uint(bs[i]),
                       bs1 = __float_as_uint(bs[i + LD]);
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(w, ps[u], bb0, bb1);
        mma_tf32(w, pb[u], bs0, bs1);
        mma_tf32(w, pb[u], bb0, bb1);
#pragma unroll
        for (int e = 0; e < 4; ++e) t[e] += w[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += t[e];
    }
  }
}

// s[j] = A B_j^T over the head dim, bfloat16: `a_addr` the lane's ldmatrix
// row of the warp's 16 rows of A, `b_addr` its row of B's first two 8-row
// tiles (non-transposed: ldmatrix matrices 0 and 1 are tile j, k 0-7 and
// 8-15; 2 and 3 tile j + 1)
template <int D, int NT, int LD>
__device__ __forceinline__ void scores_bf16(float (&s)[NT][4],
                                            uint32_t a_addr,
                                            uint32_t b_addr) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a_addr + kk * 32, a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b_addr + (j * 8 * LD + kk * 16) * 2, b0, b1, b2, b3);
      mma_bf16(s[j], a, b0, b1);
      mma_bf16(s[j + 1], a, b2, b3);
    }
  }
}

// the bfloat16 pairs (hi, lo) of two float32 values, hi = bf16(x) and
// lo = bf16(x - hi): x to about 2^-17 of itself
__device__ __forceinline__ void pack_bf16_split(float x0, float x1,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[c] += P B, bfloat16, over NK 16-wide k-steps: P from its
// accumulators (tiles 2 kk and 2 kk + 1 are one A fragment) as two
// bfloat16 terms, lo then hi, B's k rows through ldmatrix.trans at
// `b_addr` (the lane's row of the first output tiles)
template <int NK, int NO, int LD>
__device__ __forceinline__ void accumulate_bf16(float (&acc)[NO][4],
                                                const float (&p)[2 * NK][4],
                                                uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t hi[4], lo[4];
    pack_bf16_split(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    pack_bf16_split(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    pack_bf16_split(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    pack_bf16_split(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int c = 0; c < NO; c += 2) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b_addr + (kk * 16 * LD + c * 8) * 2, b0, b1, b2, b3);
      mma_bf16(acc[c], lo, b0, b1);
      mma_bf16(acc[c], hi, b0, b1);
      mma_bf16(acc[c + 1], lo, b2, b3);
      mma_bf16(acc[c + 1], hi, b2, b3);
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------- 1. dQ
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dO,
              const float* __restrict__ lse, float2* __restrict__ stats,
              T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
              float scale, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using C = Tiles<D, kF32>;
  constexpr int BQ = kQRows, BK = C::kBK, LD = C::kLd;
  constexpr int NS = BK / 8;  // 8-key tiles of S
  constexpr int NO = D / 8;   // 8-wide tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * LD;
  T* Ks = dOs + BQ * LD;     // two stages of BK rows
  T* Vs = Ks + 2 * BK * LD;  // two stages of BK rows
  T* Kss = Vs + 2 * BK * LD;  // f32: small halves, one stage
  T* Vss = Kss + BK * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row and column
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest tiles first
  const int offset = Sk - Sq;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t bk = static_cast<int64_t>(b) * Hkv + h / (H / Hkv);
  const T* kb = k + bk * Sk * D;
  const T* vb = v + bk * Sk * D;

  const int n_kt = key_tiles<BQ, BK>(q0, Sq, Sk, offset, causal);
  load_rows<D, BQ, LD>(Qs, q + bh * Sq * D, q0, Sq, tid);
  load_rows<D, BQ, LD>(dOs, dO + bh * Sq * D, q0, Sq, tid);
  if (n_kt > 0) {
    load_rows<D, BK, LD>(Ks, kb, 0, Sk, tid);
    load_rows<D, BK, LD>(Vs, vb, 0, Sk, tid);
  }
  cp_async_commit();

  // this lane's two rows (g and g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float c0 = row0 < Sq ? lse[bh * Sq + row0] * kLog2e : 0.f;
  const float c1 = row1 < Sq ? lse[bh * Sq + row1] * kLog2e : 0.f;
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // sweep 1's sums
  float il0 = 0.f, il1 = 0.f, D0 = 0.f, D1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  const T* Qw = Qs + warp * 16 * LD;
  const T* dOw = dOs + warp * 16 * LD;
  const int n_t = 2 * n_kt;  // two sweeps over the same key tiles
  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    const int k0 = (t < n_kt ? t : t - n_kt) * BK;
    if (t + 1 < n_t) {
      const int k1 = (t + 1 < n_kt ? t + 1 : t + 1 - n_kt) * BK;
      load_rows<D, BK, LD>(Ks + (buf ^ 1) * BK * LD, kb, k1, Sk, tid);
      load_rows<D, BK, LD>(Vs + (buf ^ 1) * BK * LD, vb, k1, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; tile t - 1's small halves consumed
    T* Kb = Ks + buf * BK * LD;
    T* Vb = Vs + buf * BK * LD;
    if constexpr (kF32) {
      split_tiles<D, BK, LD>(Kb, Kss, Vb, Vss, tid);
      __syncthreads();  // the split is complete
    }
    if (t == n_kt) {
      // the rows' l and D from the four lanes that hold them
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      }
      il0 = l0 > 0.f ? 1.f / l0 : 0.f;
      il1 = l1 > 0.f ? 1.f / l1 : 0.f;
      D0 = l0 > 0.f ? d0 / l0 : 0.f;
      D1 = l1 > 0.f ? d1 / l1 : 0.f;
      if (t4 == 0) {
        if (row0 < Sq) stats[bh * Sq + row0] = make_float2(il0, D0);
        if (row1 < Sq) stats[bh * Sq + row1] = make_float2(il1, D1);
      }
    }

    // e of the lane's (row, key) pairs from S = Q K^T; masked pairs 0
    float s[NS][4], dp[NS][4];
    if constexpr (kF32) {
      scores_f32<D, NS, LD, false>(s, Qw, Kb, Kss, g, t4);
    } else {
      scores_bf16<D, NS, LD>(
          s, smem_addr(Qw + (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8),
          smem_addr(Kb + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8));
    }
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ci = e < 2 ? c0 : c1;
        float x = exp2f(s[j][e] * scale_log2 - ci);
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = (e < 2 ? row0 : row1) + offset;
          if (kpos >= Sk || (causal && kpos > qpos)) x = 0.f;
        }
        s[j][e] = x;
      }
    // dP = dO V^T
    if constexpr (kF32) {
      scores_f32<D, NS, LD, false>(dp, dOw, Vb, Vss, g, t4);
    } else {
      scores_bf16<D, NS, LD>(
          dp, smem_addr(dOw + (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8),
          smem_addr(Vb + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8));
    }
    if (t < n_kt) {
      // sweep 1: this tile's sums alone, then added to the rows' totals
      float tl0 = 0.f, tl1 = 0.f, td0 = 0.f, td1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        tl0 += s[j][0] + s[j][1];
        tl1 += s[j][2] + s[j][3];
        td0 = fmaf(s[j][0], dp[j][0], fmaf(s[j][1], dp[j][1], td0));
        td1 = fmaf(s[j][2], dp[j][2], fmaf(s[j][3], dp[j][3], td1));
      }
      l0 += tl0;
      l1 += tl1;
      d0 += td0;
      d1 += td1;
    } else {
      // sweep 2: dS = P (dP - D), dQ += dS K
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        dp[j][0] = s[j][0] * il0 * (dp[j][0] - D0);
        dp[j][1] = s[j][1] * il0 * (dp[j][1] - D0);
        dp[j][2] = s[j][2] * il1 * (dp[j][2] - D1);
        dp[j][3] = s[j][3] * il1 * (dp[j][3] - D1);
      }
      if constexpr (kF32) {
        // a fresh sum for each 8-key step's products
        accumulate_f32<NS, NO, LD, 1>(acc, dp, Kb, Kss, g, t4);
      } else {
        accumulate_bf16<NS / 2, NO, LD>(
            acc, dp,
            smem_addr(Kb + ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8));
      }
    }
    __syncthreads();  // this stage is consumed; tile t + 2 may land in it
  }
  cp_async_wait<0>();
  if (n_kt == 0 && t4 == 0) {  // rows that see no key
    if (row0 < Sq) stats[bh * Sq + row0] = make_float2(0.f, 0.f);
    if (row1 < Sq) stats[bh * Sq + row1] = make_float2(0.f, 0.f);
  }

  T* out = dq + bh * Sq * D;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = c * 8 + 2 * t4;
    if (row0 < Sq)
      store2(out + static_cast<int64_t>(row0) * D + col, acc[c][0] * scale,
             acc[c][1] * scale);
    if (row1 < Sq)
      store2(out + static_cast<int64_t>(row1) * D + col, acc[c][2] * scale,
             acc[c][3] * scale);
  }
}

// ---------------------------------------------------------- 2. dK, dV
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse,
                const float2* __restrict__ stats, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                int causal, float scale, float scale_log2) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using C = Tiles<D, kF32>;
  constexpr int BQ = C::kBQ, BKV = C::kKeys, LD = C::kLd, CS = C::kCS;
  constexpr int NQ = BQ / 8;   // 8-query tiles of S^T
  constexpr int DC = D / CS;   // dK / dV columns of a warp
  constexpr int NO = DC / 8;   // 8-wide tiles of them
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BKV * LD;
  T* Qs = Vs + BKV * LD;      // two stages of BQ rows
  T* dOs = Qs + 2 * BQ * LD;  // two stages of BQ rows
  T* Qss = dOs + 2 * BQ * LD;  // f32: small halves, one stage
  T* dOss = Qss + (kF32 ? BQ * LD : 0);
  float2* st_s = reinterpret_cast<float2*>(dOss + (kF32 ? BQ * LD : 0));
  float* lse_s = reinterpret_cast<float*>(st_s + 2 * BQ);  // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row and column
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix row and matrix
  const int kw = warp / CS, col0 = (warp % CS) * DC;  // keys, columns
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;  // the first tiles see the most queries
  const int group = H / Hkv, offset = Sk - Sq;
  const int64_t bk = static_cast<int64_t>(b) * Hkv + hk;

  // query tiles that see the block's keys, for each head of the group
  const int qt0 = (causal ? max(0, k0 - offset) : 0) / BQ;
  const int n_qt = max(0, (Sq + BQ - 1) / BQ - qt0);
  const int n_t = group * n_qt;
  // tile t: head hk * group + t / n_qt, query rows from q0
  auto tile_rows = [&](int t, int& q0) -> int64_t {
    q0 = (qt0 + t % n_qt) * BQ;
    return static_cast<int64_t>(b) * H + hk * group + t / n_qt;
  };
  auto load_tile = [&](int t, int stage) {
    int q0;
    const int64_t bh = tile_rows(t, q0);
    load_rows<D, BQ, LD>(Qs + stage * BQ * LD, q + bh * Sq * D, q0, Sq, tid);
    load_rows<D, BQ, LD>(dOs + stage * BQ * LD, dO + bh * Sq * D, q0, Sq,
                         tid);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool in = q0 + r < Sq;
      const int64_t i = bh * Sq + (in ? q0 + r : 0);
      cp_async8(smem_addr(st_s + stage * BQ + r), stats + i, in);
      cp_async4(smem_addr(lse_s + stage * BQ + r), lse + i, in);
    }
  };

  load_rows<D, BKV, LD>(Ks, k + bk * Sk * D, k0, Sk, tid);
  load_rows<D, BKV, LD>(Vs, v + bk * Sk * D, k0, Sk, tid);
  if (n_t > 0) load_tile(0, 0);
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  // this lane's two keys (g and g + 8 of the warp's 16)
  const int key0 = k0 + kw * 16 + g, key1 = key0 + 8;
  const T* Kw = Ks + kw * 16 * LD;
  const T* Vw = Vs + kw * 16 * LD;
  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    int q0;
    tile_rows(t, q0);
    if (t + 1 < n_t) {
      load_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; tile t - 1's small halves consumed
    T* Qb = Qs + buf * BQ * LD;
    T* dOb = dOs + buf * BQ * LD;
    const float2* st = st_s + buf * BQ;
    const float* ls = lse_s + buf * BQ;
    if constexpr (kF32) {
      split_tiles<D, BQ, LD>(Qb, Qss, dOb, dOss, tid);
      __syncthreads();  // the split is complete
    }

    // P^T from S^T = K Q^T: keys (rows) key0 / key1, queries (columns)
    // q0 + 8 j + 2 t4 (+ 1)
    float p[NQ][4], dp[NQ][4];
    if constexpr (kF32) {
      scores_f32<D, NQ, LD, true>(p, Kw, Qb, Qss, g, t4);
    } else {
      scores_bf16<D, NQ, LD>(
          p, smem_addr(Kw + (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8),
          smem_addr(Qb + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8));
    }
    const bool edge = q0 + BQ > Sq || k0 + BKV > Sk ||
                      (causal && k0 + BKV - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * t4 + (e & 1);
        float x = exp2f(p[j][e] * scale_log2 - ls[r] * kLog2e) * st[r].x;
        if (edge) {
          const int qpos = q0 + r, kpos = e < 2 ? key0 : key1;
          if (qpos >= Sq || kpos >= Sk || (causal && kpos > qpos + offset))
            x = 0.f;
        }
        p[j][e] = x;
      }
    // dS^T = P^T (dP^T - D) from dP^T = V dO^T
    if constexpr (kF32) {
      scores_f32<D, NQ, LD, true>(dp, Vw, dOb, dOss, g, t4);
    } else {
      scores_bf16<D, NQ, LD>(
          dp, smem_addr(Vw + (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8),
          smem_addr(dOb + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8));
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - st[j * 8 + 2 * t4 + (e & 1)].y);

    // dV += P^T dO, dK += dS^T Q over the warp's columns (f32: a fresh
    // sum for the tile's products)
    if constexpr (kF32) {
      accumulate_f32<NQ, NO, LD, NQ>(acc_v, p, dOb + col0, dOss + col0, g,
                                     t4);
      accumulate_f32<NQ, NO, LD, NQ>(acc_k, dp, Qb + col0, Qss + col0, g,
                                     t4);
    } else {
      const int b_off = ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8 + col0;
      accumulate_bf16<NQ / 2, NO, LD>(acc_v, p, smem_addr(dOb + b_off));
      accumulate_bf16<NQ / 2, NO, LD>(acc_k, dp, smem_addr(Qb + b_off));
    }
    __syncthreads();  // this stage is consumed; tile t + 2 may land in it
  }
  cp_async_wait<0>();

  T* kout = dk + bk * Sk * D;
  T* vout = dv + bk * Sk * D;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const int col = col0 + c * 8 + 2 * t4;
    if (key0 < Sk) {
      store2(kout + static_cast<int64_t>(key0) * D + col,
             acc_k[c][0] * scale, acc_k[c][1] * scale);
      store2(vout + static_cast<int64_t>(key0) * D + col, acc_v[c][0],
             acc_v[c][1]);
    }
    if (key1 < Sk) {
      store2(kout + static_cast<int64_t>(key1) * D + col,
             acc_k[c][2] * scale, acc_k[c][3] * scale);
      store2(vout + static_cast<int64_t>(key1) * D + col, acc_v[c][2],
             acc_v[c][3]);
    }
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
  using C = Tiles<D, std::is_same<T, float>::value>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dOt = static_cast<const T*>(dO);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  // the forward's own constant, so x = s scale_log2 rounds as it did there
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(D)));
  int err = set_smem(dq_kernel<D, T>, C::kQBytes);
  if (err) return err;
  dq_kernel<D, T><<<dim3(H, B, (Sq + kQRows - 1) / kQRows), kThreads,
                    C::kQBytes, stream>>>(
      qt, kt, vt, dOt, lse, stats, static_cast<T*>(dq), H, Hkv, Sq, Sk,
      causal, scale, scale_log2);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = set_smem(dkdv_kernel<D, T>, C::kKvBytes))) return err;
  dkdv_kernel<D, T><<<dim3(Hkv, B, (Sk + C::kKeys - 1) / C::kKeys),
                      kThreads, C::kKvBytes, stream>>>(
      qt, kt, vt, dOt, lse, stats, static_cast<T*>(dk), static_cast<T*>(dv),
      H, Hkv, Sq, Sk, causal, scale, scale_log2);
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

// dynamic shared memory, registers, local (spill) bytes and resident
// blocks an SM of the current device holds, of one kernel (0 dQ, 1 dK/dV)
template <int D, typename T>
int resources(int kernel, int64_t* out) {
  using C = Tiles<D, std::is_same<T, float>::value>;
  const void* fn = kernel == 0
                       ? reinterpret_cast<const void*>(dq_kernel<D, T>)
                       : reinterpret_cast<const void*>(dkdv_kernel<D, T>);
  const size_t smem = kernel == 0 ? C::kQBytes : C::kKvBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        kThreads, smem);
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

// q, dO, dq (B, H, Sq, Dh) and k, v, dk, dv (B, Hkv, Sk, Dh), contiguous,
// one type, 16-byte aligned; lse (B, H, Sq) float32 from the forward;
// stats a float32 scratch of 2 B H Sq floats.  causal: 0 or 1.  Two
// launches.
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

// out[4]: dynamic shared memory bytes, registers a thread, local bytes a
// thread and resident blocks an SM of one kernel (0: dQ, 1: dK/dV) of the
// instance (is_bf16, Dh)
int flash_attention_bwd_resources(int is_bf16, int64_t Dh, int kernel,
                                  int64_t* out) {
  if (kernel != 0 && kernel != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(Dh, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return is_bf16 ? resources<kD, bf16>(kernel, out)
                   : resources<kD, float>(kernel, out);
  });
}

}  // extern "C"
