// Mamba2 SSD chunked scan backward on Hopper's tensor cores.
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
//
// with M_ts = e^{a_t-a_s} (C_t.B_s)(dy_t.x_s) and w_s = e^{a_{Q-1}-a_s}
// x_s.(g B_s); ddA is the reverse cumulative sum of da within the tile.
// The states come from the inputs alone (the forward keeps none):
//
//   h_{c+1} = e^{a_{Q-1}} h_c + s_c,   s_c = sum_j e^{a_{Q-1}-a_j} x_j^T B_j
//   g_{c-1} = e^{a_{Q-1}} g_c + r_c,   r_c = sum_t e^{a_t} dy_t^T C_t
//
// (h_0 = 0, g of the last tile = gT), the forward's stages 1-2 and their
// mirror image for the gradient.
//
// Launches (chunk-parallel, as the forward's stages 1-2: the sequential
// walk over the tiles that came before took 0.73-1.05 ms of 2.9-3.9 on an
// H100, tools/ssd_bwd_split.py):
//
//   1. tile states, grid (tiles, H, B): a block stages its tile's B and C
//      (cp.async) and its decayed rows e^{a_{Q-1}-a_j} x_j and e^{a_t} dy_t
//      (16-byte loads, all issued before the first is stored), and writes
//      the tile's own s_c and r_c (P x N each), e^{a_{Q-1}}, and a_t with
//      its exponentials for launch 3;
//   2. state passing, one (p, n) element a thread, grid (P N / 256, B H, 2):
//      z = 0 walks the tiles forward and overwrites s_c with h_c, z = 1
//      walks them backward from gT and overwrites r_c with g_c, the loads of
//      the next 8 tiles in flight before this one is stored;
//   3. tile gradients, grid (tiles, heads / hpb, B): a block serves hpb =
//      min(4, H / G) consecutive heads of one group (the last block of a
//      group fewer where hpb does not divide H / G), stages the tile's B
//      and C and forms C B^T once for all of them, and for each head, in
//      order, stages x, dy, g and the tile's a_t (cp.async), forms dy x^T,
//      the masked, decayed W = L o C B^T and V = L o dy x^T, swaps h in
//      over g, and writes dx and ddA (da and its reverse sum by one warp,
//      two rows a lane); dB and dC are summed over the block's heads in
//      head order in registers and written once a block (float32,
//      (B, H / hpb, S, N));
//   4. group sums: dB and dC of each group as the sum of its blocks'
//      partials, in order, stored in the inputs' type.
//   No atomics anywhere: two runs give the same bits.
//
// Arithmetic: every product on the tensor cores.  8 warps; a product's
// output is cut in 16-row tiles (one m16 row of mma tiles a warp) and
// column ranges (the tile gradients: 4 row groups x 2 column halves; as
// 4 x 4 with 16 warps they took up to 31 % longer), each warp loading its
// fragments from shared memory with scalar loads in the PTX fragment
// layouts (row g = lane / 4, column t4 = lane % 4).  Each k-step's
// products are summed in a fresh accumulator and added to the output in
// float32 (the tensor cores truncate what a sum drops: a long chain in one
// accumulator is biased toward zero, which moved a held training step in
// flash_attention_bwd.cu).
//
// bfloat16: `mma.sync.m16n8k16`, float32 accumulators.  The inputs (x,
//   dy, B, C) are bfloat16 already and go in as they are.  An operand
//   formed in float32 (the decayed rows, W, V, g and h) goes in as a
//   bfloat16 pair, hi = bf16(v) and lo = bf16(v - hi), two products (lo,
//   then hi): rounded to one bfloat16 the emulation in
//   tests/test_torch_backward.py put dx at up to 2.6x the plain version's
//   float64-referenced error against the 2x rule; as pairs, 1.00x.  Input
//   tiles are staged as bfloat16 rows padded by 8 elements, so a lane's
//   32-bit load of two k-neighbours falls on its own bank.
// float32: 3xTF32 on `mma.sync.m16n8k8`, flash_attention.cu's split: x =
//   big + small, big = tf32_rna(x), small = tf32_rna(x - big), a product
//   small x big + big x small + big x big: float32 accuracy whatever
//   `allow_tf32` says.  Operands are split in registers as their fragments
//   are loaded.  Rows padded by 4 floats (padding each buffer for the
//   fragment loads its products make most, 4 or 8, changed nothing).
// The sums (the state passing, the head and group sums, da and its reverse
// cumulative sum, w and <g, h>) are float32 on the CUDA cores: warp
// shuffles in fixed trees, then shared memory in warp order.
//
// What bounds it: operations.  Per (b, group, tile) C B^T once, and per
// (b, h, tile) dy x^T and the six products dx, dB, dC, g B^T, x g and
// dy h (Q Q P or Q P N multiply-adds each), plus the two tile states
// (Q P N each).  Counted at the tile that needs the least (chip_smoke.py's
// `ssd_bwd_ops`), mamba2-2.7b's shape (B 2, H 80, G 1, S 2048, P 64, N 128)
// needs 28.7 GFLOP: in float32 0.174 ms as 3xTF32 at the card's 495 TFLOP/s
// (0.428 ms at the CUDA cores' float32 rate), in bfloat16 0.029 ms at 989
// TFLOP/s, under the 0.041 ms its 136 MB of inputs and outputs take at
// 3.35 TB/s.  This design computes the whole Q x Q products, but for the
// three with a triangular operand (W^T dy, V^T C, V B), whose k-steps stop
// at the warp's diagonal block.  With the products removed the tile
// gradients took 34-42 % of their time on an H100 (the rest is the
// products: their fragment loads, splits and sums in registers, not the
// tensor cores, set the pace), and without their per-head loads 9-19 %
// less.
//
// Scratch it streams (float32, allocated by the wrapper,
// `ssd_scan_bwd_scratch_floats`): the tile states (B, H, tiles, P, N)
// twice (s / h and r / g: 168 MB each at the main shape), written by 1,
// read and rewritten by 2 and read by 3; the block partials of dB and dC,
// (B, H / hpb, S, N) each (42 MB each), written by 3 and read by 4; the
// tiles' a_t and exponentials (5 MB): about 1.5 GB, 0.45 ms at 3.35 TB/s,
// the floor of this design in both types.
//
// Instances: P and N padded to (64, 64), (64, 128) or (128, 128) with zero
// rows and columns (zamba2, mamba2, the rest).  Shared memory (KB) of the
// tile gradients: float32 105.5 / 153.5 / 218.5, bfloat16 73.5 / 105.5 /
// 154.5; of the tile states: float32 69 / 101 / 133, bfloat16 53 / 69 /
// 101.  The tile gradients keep C B^T and the block's dB and dC sums in
// registers across its heads (224-255 registers a thread; 196 bytes of
// spills in bfloat16 at (128, 128)): one block an SM, but two at (64, 64)
// in float32, where shared memory allows it and ptxas's 128-register cap
// (132 bytes of spills) paid, 15 % faster at zamba2's shape; in bfloat16
// the same cap cost 12-40 %.  The tile states run two or three
// blocks an SM, as many as their shared memory allows (up to three); with
// their paired stores that took 24 % off their time at mamba2's shape in
// float32, 39 % in bfloat16.  chip_smoke.py prints ptxas's report of every
// kernel.
//
// The entry points return the CUDA error code of the first launch that
// fails so the wrapper raises; the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;           // 8 warps (tile states)
constexpr int kWarps = kThreads / 32;
// tile gradients: 4 groups of 16 rows times kTileCols column groups, a
// warp each
constexpr int kTileCols = 2;
constexpr int kTileWarps = 4 * kTileCols;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kT = 64;                  // rows of a tile, at most
constexpr int kMaxPN = 128;             // P and N
constexpr int kMaxHeadsPerBlock = 4;    // heads of a tile-gradient block
constexpr int kBatch = 8;               // state passing: tiles loaded ahead
constexpr size_t kSmemPerSM = 232448;   // shared memory an SM's blocks share

// blocks an SM can hold by shared memory (1 KB of each kept by the
// system), at most `most`: the kernels' __launch_bounds__ minimum, so
// ptxas keeps their registers within that many blocks' share
constexpr int blocks_by_smem(size_t bytes, int most) {
  return static_cast<int>(kSmemPerSM / (bytes + 1024)) < most
             ? static_cast<int>(kSmemPerSM / (bytes + 1024))
             : most;
}

struct Shape {
  int H, G, S, P, N, Tq, nT, hpb, nhb;  // nhb: tile blocks a group
};

// an input element as staged: float32 as it is, bfloat16 as its 16 bits
template <bool F32>
using In = typename std::conditional<F32, float, uint16_t>::type;

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16(x));
}

// row[c] = a and row[c + 1] = b where they are < cols (c even): one 8- or
// 4-byte store where cols is even, so a warp's stores to a row are whole
// sectors
__device__ __forceinline__ void put_pair(float* row, int c, int cols, float a,
                                         float b) {
  if (cols % 2 == 0 && c + 1 < cols) {
    *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
  } else {
    if (c < cols) row[c] = a;
    if (c + 1 < cols) row[c + 1] = b;
  }
}
__device__ __forceinline__ void put_pair(uint16_t* row, int c, int cols,
                                         float a, float b) {
  if (cols % 2 == 0 && c + 1 < cols) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<uint32_t*>(row + c) =
        *reinterpret_cast<const uint32_t*>(&v);
  } else {
    if (c < cols) put(row + c, a);
    if (c + 1 < cols) put(row + c + 1, b);
  }
}

// ------------------------------------------------------------ PTX helpers
// c += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, float32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// x rounded to TF32 to nearest, ties away from zero (`cvt.rna.tf32.f32`)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + what neither keeps (about 2^-22 of x), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// the bfloat16 pairs (hi, lo) of two float32 values (first in the low
// half), hi = bf16(x) and lo = bf16(x - hi): x to about 2^-17 of itself
__device__ __forceinline__ void pair_bf16(float x0, float x1, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __bfloat162float(h.x), x1 - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes global -> shared, asynchronously; with !valid the 16 bytes are
// zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// every copy this thread issued has landed (visible to the block after a
// __syncthreads)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// ------------------------------------------------------- warp products
// A product operand in shared memory: element (i, k) of its m (or n) index
// i and k-index k at p[i * ld + k] (KC, k contiguous) or p[k * ld + i]
template <typename E, bool KC>
struct Op {
  const E* p;
  int ld;
  __device__ __forceinline__ E at(int i, int k) const {
    return KC ? p[i * ld + k] : p[k * ld + i];
  }
};

// the 32-bit register of elements (i, k) and (i, k + 1), k even: a
// bfloat16 input as it is, a float32 operand as its bfloat16 pair
template <bool KC>
__device__ __forceinline__ uint32_t reg(const Op<uint16_t, KC>& o, int i,
                                        int k) {
  if (KC) return *reinterpret_cast<const uint32_t*>(o.p + i * o.ld + k);
  return static_cast<uint32_t>(o.at(i, k)) |
         static_cast<uint32_t>(o.at(i, k + 1)) << 16;
}
template <bool KC>
__device__ __forceinline__ void reg(const Op<float, KC>& o, int i, int k,
                                    uint32_t& hi, uint32_t& lo) {
  float x0, x1;
  if (KC) {
    const float2 v = *reinterpret_cast<const float2*>(o.p + i * o.ld + k);
    x0 = v.x, x1 = v.y;
  } else {
    x0 = o.at(i, k), x1 = o.at(i, k + 1);
  }
  pair_bf16(x0, x1, hi, lo);
}

// acc[j] += A[m0 + (0..15)][k] B[k][n0 + 8 j + (0..7)] over k in [k0, k1)
// (multiples of 16), A(i, k) = a.at(i, k), B(k, n) = b.at(n, k).  F32:
// 3xTF32 m16n8k8, every operand split; otherwise bfloat16 m16n8k16 with a
// float32 operand (at most one of the two) as its bfloat16 pair.  Each
// k-step of each output tile is summed in a fresh accumulator.
template <bool F32, int NT, typename EA, bool KA, typename EB, bool KB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const Op<EA, KA>& a,
                                         const Op<EB, KB>& b, int m0, int n0,
                                         int k0, int k1, int g, int t4) {
  const int i0 = m0 + g, i1 = i0 + 8;
  if constexpr (F32) {
    for (int kk = k0; kk < k1; kk += 8) {
      uint32_t ab[4], as[4];
      split_tf32(a.at(i0, kk + t4), ab[0], as[0]);
      split_tf32(a.at(i1, kk + t4), ab[1], as[1]);
      split_tf32(a.at(i0, kk + t4 + 4), ab[2], as[2]);
      split_tf32(a.at(i1, kk + t4 + 4), ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(b.at(n, kk + t4), bb0, bs0);
        split_tf32(b.at(n, kk + t4 + 4), bb1, bs1);
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(w, as, bb0, bb1);
        mma_tf32(w, ab, bs0, bs1);
        mma_tf32(w, ab, bb0, bb1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += w[e];
      }
    }
  } else {
    constexpr bool kPairA = std::is_same<EA, float>::value;
    constexpr bool kPairB = std::is_same<EB, float>::value;
    static_assert(!(kPairA && kPairB), "one bfloat16 pair a product");
    const int c0 = 2 * t4, c1 = c0 + 8;
    for (int kk = k0; kk < k1; kk += 16) {
      uint32_t ah[4], al[4];
      if constexpr (kPairA) {
        reg(a, i0, kk + c0, ah[0], al[0]);
        reg(a, i1, kk + c0, ah[1], al[1]);
        reg(a, i0, kk + c1, ah[2], al[2]);
        reg(a, i1, kk + c1, ah[3], al[3]);
      } else {
        ah[0] = reg(a, i0, kk + c0);
        ah[1] = reg(a, i1, kk + c0);
        ah[2] = reg(a, i0, kk + c1);
        ah[3] = reg(a, i1, kk + c1);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + g;
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (kPairB) {
          uint32_t bh0, bl0, bh1, bl1;
          reg(b, n, kk + c0, bh0, bl0);
          reg(b, n, kk + c1, bh1, bl1);
          mma_bf16(w, ah, bl0, bl1);
          mma_bf16(w, ah, bh0, bh1);
        } else {
          const uint32_t b0 = reg(b, n, kk + c0), b1 = reg(b, n, kk + c1);
          if constexpr (kPairA) mma_bf16(w, al, b0, b1);
          mma_bf16(w, ah, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += w[e];
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ---------------------------------------------------------- tile helpers
// a + b = s + e exactly (Knuth's two-sum)
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// cs[t] + csl[t] = dA[0] + ... + dA[t] over the tile's rows, dA 0 past
// `rows`: two warps scan 32 rows each with shuffles, the second then adds
// the first's total, every add a two-sum whose rounding is carried in csl.
// A plain tree scan rounds cs_t and cs_s apart, so e^{cs_t - cs_s} of
// neighbouring rows carried ~|cs| 2^-24 of error, not ~|cs_t - cs_s| 2^-24
// as a sequential sum's: it put dx at 1.8x the plain version's
// float64-referenced error in a CPU run of this source.  e^{cs} to ex and
// e^{cs[kT-1] - cs} to dec.  Ends with all of it visible to the block.
__device__ __forceinline__ void tile_cumsum(float* cs, float* csl, float* ex,
                                            float* dec, const float* dA,
                                            int rows, int tid) {
  if (tid < kT) {
    float v = tid < rows ? dA[tid] : 0.f, lo = 0.f;
    const int lane = tid & 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      const float ul = __shfl_up_sync(0xffffffffu, lo, off);
      if (lane >= off) {
        float e;
        two_sum(v, u, v, e);
        lo += ul + e;
      }
    }
    cs[tid] = v;
    csl[tid] = lo;
  }
  __syncthreads();
  if (tid >= 32 && tid < kT) {
    float v, e;
    two_sum(cs[tid], cs[31], v, e);
    cs[tid] = v;
    csl[tid] += csl[31] + e;
  }
  __syncthreads();
  if (tid < kT) {
    ex[tid] = expf(cs[tid] + csl[tid]);
    dec[tid] = expf((cs[kT - 1] - cs[tid]) + (csl[kT - 1] - csl[tid]));
  }
  __syncthreads();
}

// rows [0, rows) x columns [0, cols) of a row-major (., cols) matrix into
// dst[r][c] (ROWS rows of LD elements, WIDTH of them written) as staged;
// the rest of the ROWS x WIDTH block 0.  Rows whose length is a multiple
// of 16 bytes go as cp.async copies of 16 bytes (the caller waits with
// cp_async_wait_all); other shapes element by element.
template <int ROWS, int WIDTH, int LD, int NTH = kThreads, typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, int rows,
                                      int cols, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  if (cols % kPer == 0) {
    for (int e = tid; e < ROWS * WIDTH / kPer; e += NTH) {
      const int r = e / (WIDTH / kPer), c = (e % (WIDTH / kPer)) * kPer;
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * LD + c,
                 in ? src + static_cast<int64_t>(r) * cols + c : src, in);
    }
  } else {
    for (int e = tid; e < ROWS * WIDTH; e += NTH) {
      const int r = e / WIDTH, c = e % WIDTH;
      dst[r * LD + c] = r < rows && c < cols
                            ? src[static_cast<int64_t>(r) * cols + c]
                            : E(0);
    }
  }
}

// the floats of a 16-byte piece of staged elements
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// kT rows as `stage` reads them into float32, row r times scale[r]: a
// thread's 16-byte loads are all issued before the first is stored
template <int WIDTH, int LD, typename E>
__device__ __forceinline__ void stage_scaled(float* dst, const E* src,
                                             int rows, int cols,
                                             const float* scale, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  constexpr int kEach = kT * WIDTH / kPer / kThreads;
  if (cols % kPer == 0) {
    uint4 v[kEach];
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / (WIDTH / kPer), c = (e % (WIDTH / kPer)) * kPer;
      v[u] = r < rows && c < cols
                 ? *reinterpret_cast<const uint4*>(
                       src + static_cast<int64_t>(r) * cols + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / (WIDTH / kPer), c = (e % (WIDTH / kPer)) * kPer;
      float f[kPer];
      unpack(v[u], f);
      const float sc = scale[r];
#pragma unroll
      for (int q = 0; q < kPer; q += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + q) =
            make_float4(f[q] * sc, f[q + 1] * sc, f[q + 2] * sc,
                        f[q + 3] * sc);
    }
  } else {
    for (int e = tid; e < kT * WIDTH; e += kThreads) {
      const int r = e / WIDTH, c = e % WIDTH;
      dst[r * LD + c] =
          r < rows && c < cols
              ? val(src[static_cast<int64_t>(r) * cols + c]) * scale[r]
              : 0.f;
    }
  }
}

// the P x N state at src over the KP x KN block at Ms (rows of LD floats,
// zero past P and N), returning this thread's share of the dot product of
// the two; a thread's 16-byte loads go four at a time
template <int KP, int KN, int LD, int NTH>
__device__ __forceinline__ float swap_in(float* Ms, const float* src, int P,
                                         int N, int tid) {
  float dot = 0.f;
  if (N % 4 == 0) {
    constexpr int kEach = KP * KN / 4 / NTH, kAhead = kEach < 4 ? kEach : 4;
#pragma unroll
    for (int u0 = 0; u0 < kEach; u0 += kAhead) {
      float4 v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int e = tid + (u0 + u) * NTH;
        const int p = e / (KN / 4), n = (e % (KN / 4)) * 4;
        v[u] = p < P && n < N
                   ? *reinterpret_cast<const float4*>(src + p * N + n)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int e = tid + (u0 + u) * NTH;
        float4* m = reinterpret_cast<float4*>(
            Ms + (e / (KN / 4)) * LD + (e % (KN / 4)) * 4);
        const float4 o = *m;
        dot = fmaf(o.x, v[u].x, dot);
        dot = fmaf(o.y, v[u].y, dot);
        dot = fmaf(o.z, v[u].z, dot);
        dot = fmaf(o.w, v[u].w, dot);
        *m = v[u];
      }
    }
  } else {
    for (int e = tid; e < KP * KN; e += NTH) {
      const int p = e / KN, n = e % KN;
      const float v = p < P && n < N ? src[p * N + n] : 0.f;
      dot = fmaf(Ms[p * LD + n], v, dot);
      Ms[p * LD + n] = v;
    }
  }
  return dot;
}

// ------------------------------------------------------- 1. tile states
template <bool F32, int KP, int KN>
struct StateSmem {
  static constexpr int kLdX = KP + 4;                // float32 decayed rows
  static constexpr int kLdN = KN + (F32 ? 4 : 8);    // inputs B, C
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kT * kLdX + 4 * kT) +
      sizeof(In<F32>) * 2 * kT * kLdN;
};

template <bool F32, int KP, int KN>
__global__ void __launch_bounds__(
    kThreads, blocks_by_smem(StateSmem<F32, KP, KN>::kBytes, 3))
    ssd_bwd_states_kernel(const In<F32>* __restrict__ xdt,
                          const float* __restrict__ dA,
                          const In<F32>* __restrict__ Bm,
                          const In<F32>* __restrict__ Cm,
                          const In<F32>* __restrict__ dy,
                          float* __restrict__ hs, float* __restrict__ gs,
                          float* __restrict__ decay, float* __restrict__ sums,
                          Shape d) {
  using E = In<F32>;
  using Sm = StateSmem<F32, KP, KN>;
  constexpr int LDX = Sm::kLdX, LDN = Sm::kLdN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // every tile starts on 16 bytes (the cp.async copies' alignment)
  float* Xd = reinterpret_cast<float*>(smem_raw);  // kT x LDX: dec_j x[j][p]
  float* Yd = Xd + kT * LDX;                        // kT x LDX: ex_t dy[t][p]
  float* cs = Yd + kT * LDX;                        // a_t: cs + csl
  float* csl = cs + kT;
  float* ex = csl + kT;
  float* dec = ex + kT;
  E* Bs = reinterpret_cast<E*>(dec + kT);           // kT x LDN: B[j][n]
  E* Cs = Bs + kT * LDN;                            // kT x LDN: C[t][n]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bh = static_cast<int64_t>(b) * d.H + h;
  const int64_t bg = (static_cast<int64_t>(b) * d.G + grp) * d.S + s0;

  stage<kT, KN, LDN>(Bs, Bm + bg * d.N, rows, d.N, tid);
  stage<kT, KN, LDN>(Cs, Cm + bg * d.N, rows, d.N, tid);
  tile_cumsum(cs, csl, ex, dec, dA + bh * d.S + s0, rows, tid);
  stage_scaled<KP, LDX>(Xd, xdt + (bh * d.S + s0) * d.P, rows, d.P, dec,
                        tid);
  stage_scaled<KP, LDX>(Yd, dy + (bh * d.S + s0) * d.P, rows, d.P, ex, tid);
  cp_async_wait_all();
  __syncthreads();

  // s[p][n] = sum_j Xd[j][p] B[j][n], r[p][n] = sum_t Yd[t][p] C[t][n]:
  // warp w owns rows 16 (w % RG) .. of p and a CW-th of the columns n
  constexpr int RG = KP / 16, CW = kWarps / RG, NT = KN / (8 * CW);
  const int m0 = 16 * (warp % RG), n0 = (warp / RG) * (KN / CW);
  for (int which = 0; which < 2; ++which) {
    float acc[NT][4];
    zero(acc);
    warp_mma<F32, NT>(acc, Op<float, false>{which ? Yd : Xd, LDX},
                      Op<E, false>{which ? Cs : Bs, LDN}, m0, n0, 0, kT, g,
                      t4);
    float* out = (which ? gs : hs) + (bh * d.nT + c) * d.P * d.N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = m0 + g + 8 * u;
        if (p < d.P)
          put_pair(out + p * d.N, n0 + 8 * j + 2 * t4, d.N, acc[j][2 * u],
                   acc[j][2 * u + 1]);
      }
  }
  if (tid == 0) decay[bh * d.nT + c] = expf(cs[kT - 1] + csl[kT - 1]);
  // cs, csl, ex and dec for the tile-gradient launch
  static_assert(4 * kT == kThreads, "a thread a value");
  sums[(bh * d.nT + c) * 4 * kT + tid] = cs[tid];
}

// ---------------------------------------------------- 2. state passing
// z = 0: hs[bh][c] <- the state entering tile c (0 for the first);
// z = 1: gs[bh][c] <- the gradient of the state leaving tile c (gT, or 0,
// for the last).  One of the P N elements a thread.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_pass_kernel(float* __restrict__ hs, float* __restrict__ gs,
                        const float* __restrict__ decay,
                        const float* __restrict__ gT, int nT, int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int64_t bh = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  float* w = (rev ? gs : hs) + bh * nT * PN + e;
  const float* dc = decay + bh * nT;
  // the tile the walk reaches at step i
  auto tile = [&](int i) { return rev ? nT - 1 - i : i; };
  float run = rev && gT ? gT[bh * PN + e] : 0.f;
  float cur[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    if (u < nT) cur[u] = w[static_cast<int64_t>(tile(u)) * PN];
  for (int i0 = 0; i0 < nT; i0 += kBatch) {
    float nxt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + kBatch + u < nT)
        nxt[u] = w[static_cast<int64_t>(tile(i0 + kBatch + u)) * PN];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u >= nT) break;
      const int c = tile(i0 + u);
      w[static_cast<int64_t>(c) * PN] = run;
      run = fmaf(dc[c], run, cur[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) cur[u] = nxt[u];
  }
}

// --------------------------------------------------- 3. tile gradients
template <bool F32, int KP, int KN>
struct TileSmem {
  static constexpr int kLdN = KN + (F32 ? 4 : 8);  // inputs B, C
  static constexpr int kLdP = KP + (F32 ? 4 : 8);  // inputs x, dy
  static constexpr int kLdQ = kT + 4;              // float32 W, then V
  static constexpr int kLdM = KN + 4;              // float32 g, then h
  // cs, csl, ex, dec; partial sums of M by row (by column group) and by
  // column (4 row groups); of w and of the inter-tile term by row (by
  // column group); <g, h> by warp; rounded up to 16 bytes, where the
  // input tiles start
  static constexpr int kSmall =
      (4 * kT + 4 * kT + 3 * kTileCols * kT + kTileWarps + 3) / 4 * 4;
  static constexpr size_t kBytes =
      sizeof(In<F32>) * (2 * kT * kLdN + 2 * kT * kLdP) +
      sizeof(float) * (kT * kLdQ + KP * kLdM + kSmall);
};

// two blocks an SM where shared memory allows them in float32 (at (64, 64))
template <bool F32, int KP, int KN>
__global__ void __launch_bounds__(
    kTileThreads, F32 ? blocks_by_smem(TileSmem<F32, KP, KN>::kBytes, 2) : 1)
    ssd_bwd_tile_kernel(const In<F32>* __restrict__ xdt,
                        const float* __restrict__ dA,
                        const In<F32>* __restrict__ Bm,
                        const In<F32>* __restrict__ Cm,
                        const In<F32>* __restrict__ dy,
                        const float* __restrict__ hs,
                        const float* __restrict__ gs,
                        const float* __restrict__ sums, In<F32>* __restrict__ dx,
                        float* __restrict__ ddA, float* __restrict__ dBp,
                        float* __restrict__ dCp, Shape d) {
  using E = In<F32>;
  using Sm = TileSmem<F32, KP, KN>;
  constexpr int LDN = Sm::kLdN, LDP = Sm::kLdP, LDQ = Sm::kLdQ,
                LDM = Sm::kLdM;
  // 8-wide output tiles of a warp: its column group's share of a Q x Q,
  // Q x P or Q x N output
  constexpr int CG = kTileCols, NTH = kTileThreads;
  constexpr int NTQ = kT / (8 * CG), NTP = KP / (8 * CG),
                NTN = KN / (8 * CG);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* WV = reinterpret_cast<float*>(smem_raw);  // kT x LDQ: W[t][s], V
  float* Ms = WV + kT * LDQ;                        // KP x LDM: g[p][n], h
  float* cs = Ms + KP * LDM;  // a_t: cs + csl
  float* csl = cs + kT;
  float* ex = csl + kT;
  float* dec = ex + kT;
  float* rowp = dec + kT;        // CG x kT: sum_s M[t][s] by column group
  float* colp = rowp + CG * kT;  // 4 x kT: sum_t M[t][s] by row group
  float* wp = colp + 4 * kT;     // CG x kT: w_s by column group
  float* itp = wp + CG * kT;     // CG x kT: C_t . e^{a_t} (dy h)_t
  float* ghp = itp + CG * kT;    // kTileWarps: <g, h>
  E* Bs = reinterpret_cast<E*>(cs + Sm::kSmall);  // kT x LDN: B[s][n]
  E* Cs = Bs + kT * LDN;                  // kT x LDN: C[t][n]
  E* Xs = Cs + kT * LDN;                  // kT x LDP: x[s][p]
  E* Ys = Xs + kT * LDP;                  // kT x LDP: dy[t][p]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // the warp's 16 rows of every Q-row output, and its column group
  const int rg = warp & 3, ch = warp >> 2, m0 = 16 * rg;
  const int r0 = m0 + g, r1 = r0 + 8;  // the lane's two rows
  const int c = blockIdx.x, b = blockIdx.z;
  const int rep = d.H / d.G;
  const int grp = blockIdx.y / d.nhb;
  const int h0 = grp * rep + (blockIdx.y % d.nhb) * d.hpb;
  const int nh = min(d.hpb, grp * rep + rep - h0);
  const int s0 = c * d.Tq, rows = min(d.Tq, d.S - s0);
  const int64_t bg = (static_cast<int64_t>(b) * d.G + grp) * d.S + s0;

  stage<kT, KN, LDN, NTH>(Bs, Bm + bg * d.N, rows, d.N, tid);
  stage<kT, KN, LDN, NTH>(Cs, Cm + bg * d.N, rows, d.N, tid);
  cp_async_wait_all();
  __syncthreads();
  // the warp's first column of a Q x Q, Q x P and Q x N output
  const int n0q = ch * (kT / CG), n0p = ch * (KP / CG), n0n = ch * (KN / CG);
  // CB[t][s] = C_t . B_s for the warp's rows t and columns s, shared by
  // the block's heads
  float cb[NTQ][4];
  zero(cb);
  warp_mma<F32, NTQ>(cb, Op<E, true>{Cs, LDN}, Op<E, true>{Bs, LDN}, m0,
                     n0q, 0, KN, g, t4);

  float dBs[NTN][4], dCs[NTN][4];  // the block's sums over heads
  zero(dBs);
  zero(dCs);

  for (int hh = 0; hh < nh; ++hh) {
    const int64_t bh = static_cast<int64_t>(b) * d.H + h0 + hh;
    const int64_t st = (bh * d.nT + c) * d.P * d.N;  // this tile's state
    __syncthreads();  // the previous head's operands are consumed
    stage<kT, KP, LDP, NTH>(Xs, xdt + (bh * d.S + s0) * d.P, rows, d.P,
                            tid);
    stage<kT, KP, LDP, NTH>(Ys, dy + (bh * d.S + s0) * d.P, rows, d.P, tid);
    stage<KP, KN, LDM, NTH>(Ms, gs + st, d.P, d.N, tid);
    // cs, csl, ex, dec as the tile-states launch formed them
    stage<1, 4 * kT, 4 * kT, NTH>(cs, sums + (bh * d.nT + c) * 4 * kT, 1,
                                  4 * kT, tid);
    cp_async_wait_all();
    __syncthreads();

    // DX[t][s] = dy_t . x_s; W = L o CB to shared memory, V = L o DX
    // kept, M = W o DX summed by row and by column
    float v[NTQ][4];
    {
      float dxm[NTQ][4];
      zero(dxm);
      warp_mma<F32, NTQ>(dxm, Op<E, true>{Ys, LDP}, Op<E, true>{Xs, LDP},
                         m0, n0q, 0, KP, g, t4);
      float rs[2] = {0.f, 0.f}, col[NTQ][2];
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        col[j][0] = col[j][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1, s = n0q + 8 * j + 2 * t4 + (e & 1);
          const float l =
              s <= t ? expf((cs[t] - cs[s]) + (csl[t] - csl[s])) : 0.f;
          const float w = l * cb[j][e];
          WV[t * LDQ + s] = w;
          v[j][e] = l * dxm[j][e];
          const float m = w * dxm[j][e];
          rs[e >> 1] += m;
          col[j][e & 1] += m;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 1);
        rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 2);
      }
      if (t4 == 0) {
        rowp[ch * kT + r0] = rs[0];
        rowp[ch * kT + r1] = rs[1];
      }
#pragma unroll
      for (int j = 0; j < NTQ; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = col[j][u];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (g == 0) colp[rg * kT + n0q + 8 * j + 2 * t4 + u] = x;
        }
    }
    __syncthreads();  // W is complete

    // dx[s][p] = dec_s (B g^T)[s][p] + sum_{t>=s} W[t][s] dy[t][p];
    // w_s = dec_s x_s . (B g^T)_s
    {
      float acc[NTP][4];
      zero(acc);
      warp_mma<F32, NTP>(acc, Op<E, true>{Bs, LDN},
                             Op<float, true>{Ms, LDM}, m0, n0p, 0, KN, g, t4);
      float ws[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NTP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? r0 : r1, p = n0p + 8 * j + 2 * t4 + (e & 1);
          acc[j][e] *= dec[s];
          ws[e >> 1] = fmaf(val(Xs[s * LDP + p]), acc[j][e], ws[e >> 1]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ws[u] += __shfl_xor_sync(0xffffffffu, ws[u], 1);
        ws[u] += __shfl_xor_sync(0xffffffffu, ws[u], 2);
      }
      if (t4 == 0) {
        wp[ch * kT + r0] = ws[0];
        wp[ch * kT + r1] = ws[1];
      }
      warp_mma<F32, NTP>(acc, Op<float, false>{WV, LDQ},
                             Op<E, false>{Ys, LDP}, m0, n0p, m0, kT, g, t4);
      E* xb = dx + (bh * d.S + s0) * d.P;
#pragma unroll
      for (int j = 0; j < NTP; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int s = u ? r1 : r0;
          if (s < rows)
            put_pair(xb + static_cast<int64_t>(s) * d.P, n0p + 8 * j + 2 * t4,
                     d.P, acc[j][2 * u], acc[j][2 * u + 1]);
        }
    }
    __syncthreads();  // W is consumed
#pragma unroll
    for (int j = 0; j < NTQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        WV[(e < 2 ? r0 : r1) * LDQ + n0q + 8 * j + 2 * t4 + (e & 1)] =
            v[j][e];
    __syncthreads();  // V is complete

    // dB[s][n] = dec_s (x g)[s][n] + sum_{t>=s} V[t][s] C[t][n]
    {
      float acc[NTN][4];
      zero(acc);
      warp_mma<F32, NTN>(acc, Op<E, true>{Xs, LDP},
                             Op<float, false>{Ms, LDM}, m0, n0n, 0, KP, g,
                             t4);
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= dec[e < 2 ? r0 : r1];
      warp_mma<F32, NTN>(acc, Op<float, false>{WV, LDQ},
                             Op<E, false>{Cs, LDN}, m0, n0n, m0, kT, g, t4);
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dBs[j][e] += acc[j][e];
    }
    __syncthreads();  // g is consumed
    // h, the state entering this tile, over g; <g, h> on the way
    {
      float gh = swap_in<KP, KN, LDM, NTH>(Ms, hs + st, d.P, d.N, tid);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gh += __shfl_xor_sync(0xffffffffu, gh, off);
      if (lane == 0) ghp[warp] = gh;
    }
    __syncthreads();  // h is complete

    // dC[t][n] = e^{a_t} (dy h)[t][n] + sum_{s<=t} V[t][s] B[s][n]; the
    // inter-tile term of da_t is C_t . e^{a_t} (dy h)_t
    {
      float acc[NTN][4];
      zero(acc);
      warp_mma<F32, NTN>(acc, Op<E, true>{Ys, LDP},
                             Op<float, false>{Ms, LDM}, m0, n0n, 0, KP, g,
                             t4);
      float it[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1, n = n0n + 8 * j + 2 * t4 + (e & 1);
          acc[j][e] *= ex[t];
          it[e >> 1] = fmaf(val(Cs[t * LDN + n]), acc[j][e], it[e >> 1]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        it[u] += __shfl_xor_sync(0xffffffffu, it[u], 1);
        it[u] += __shfl_xor_sync(0xffffffffu, it[u], 2);
      }
      if (t4 == 0) {
        itp[ch * kT + r0] = it[0];
        itp[ch * kT + r1] = it[1];
      }
      warp_mma<F32, NTN>(acc, Op<float, true>{WV, LDQ},
                             Op<E, false>{Bs, LDN}, m0, n0n, 0, m0 + 16, g,
                             t4);
#pragma unroll
      for (int j = 0; j < NTN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dCs[j][e] += acc[j][e];
    }
    __syncthreads();  // every partial is written

    // da, then its reverse cumulative sum within the tile: warp 0, rows
    // 2 l and 2 l + 1 a lane, shuffles in fixed trees
    if (warp == 0) {
      float da[2], wsum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 2 * lane + u;
        float w = 0.f, row = 0.f, it = 0.f;
#pragma unroll
        for (int k = 0; k < CG; ++k) {
          w += wp[k * kT + t];
          row += rowp[k * kT + t];
          it += itp[k * kT + t];
        }
        da[u] = row -
                ((colp[t] + colp[kT + t]) +
                 (colp[2 * kT + t] + colp[3 * kT + t])) +
                it - w;
        wsum += w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      if (lane == 31) {  // row kT - 1
        float gh = 0.f;
        for (int k = 0; k < kTileWarps; ++k) gh += ghp[k];
        da[1] += ex[kT - 1] * gh + wsum;
      }
      // the lanes' pair sums summed from the last lane down
      const float pair = da[0] + da[1];
      float suf = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += u;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);  // rows > 2 l + 1
      if (lane == 31) after = 0.f;
      float* out = ddA + bh * d.S + s0;
      const float odd = da[1] + after;
      if (2 * lane < rows) out[2 * lane] = da[0] + odd;
      if (2 * lane + 1 < rows) out[2 * lane + 1] = odd;
    }
  }

  // the block's dB and dC partials
  const int64_t pb = (static_cast<int64_t>(b) * gridDim.y + blockIdx.y) * d.S
                     + s0;
#pragma unroll
  for (int j = 0; j < NTN; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = u ? r1 : r0, n = n0n + 8 * j + 2 * t4;
      if (s < rows) {
        put_pair(dBp + (pb + s) * d.N, n, d.N, dBs[j][2 * u],
                 dBs[j][2 * u + 1]);
        put_pair(dCp + (pb + s) * d.N, n, d.N, dCs[j][2 * u],
                 dCs[j][2 * u + 1]);
      }
    }
}

// ------------------------------------------------------ 4. group sums
template <typename E>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_group_sum_kernel(const float* __restrict__ dBp,
                             const float* __restrict__ dCp,
                             E* __restrict__ dB, E* __restrict__ dC,
                             int64_t per_group, int nhb, int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  // e = (b G + g) per_group + rest; block k of the group at
  // ((b G + g) nhb + k) per_group + rest
  const int64_t bg = e / per_group, rest = e % per_group;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < nhb; ++k) {
    const int64_t i = (bg * nhb + k) * per_group + rest;
    sb += dBp[i];
    sc += dCp[i];
  }
  put(dB + e, sb);
  put(dC + e, sc);
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

// heads a tile-gradient block serves, and such blocks a group
int64_t heads_per_block(int64_t rep) {
  return rep < kMaxHeadsPerBlock ? rep : kMaxHeadsPerBlock;
}
int64_t blocks_per_group(int64_t rep) {
  const int64_t hpb = heads_per_block(rep);
  return (rep + hpb - 1) / hpb;
}

struct Args {
  const void *xdt, *dA, *Bm, *Cm, *dy, *gT;
  float* scratch;
  void *dx, *ddA, *dB, *dC;
  int B;
  Shape d;
  cudaStream_t stream;
};

template <bool F32, int KP, int KN>
int run(const Args& a) {
  using E = In<F32>;
  const Shape& d = a.d;
  const int64_t states = static_cast<int64_t>(a.B) * d.H * d.nT * d.P * d.N;
  // the tile sums first: the tile-gradient launch copies them in 16-byte
  // pieces whatever P and N
  float* sums = a.scratch;
  float* hs = sums + static_cast<int64_t>(a.B) * d.H * d.nT * 4 * kT;
  float* gs = hs + states;
  float* decay = gs + states;
  float* dBp = decay + static_cast<int64_t>(a.B) * d.H * d.nT;
  float* dCp =
      dBp + static_cast<int64_t>(a.B) * d.G * d.nhb * d.S * d.N;
  const E* xdt = static_cast<const E*>(a.xdt);
  const float* dA = static_cast<const float*>(a.dA);
  const E* Bm = static_cast<const E*>(a.Bm);
  const E* Cm = static_cast<const E*>(a.Cm);
  const E* dy = static_cast<const E*>(a.dy);

  constexpr size_t s1 = StateSmem<F32, KP, KN>::kBytes;
  int err = set_smem(ssd_bwd_states_kernel<F32, KP, KN>, s1);
  if (err) return err;
  ssd_bwd_states_kernel<F32, KP, KN><<<dim3(d.nT, d.H, a.B), kThreads, s1,
                                        a.stream>>>(xdt, dA, Bm, Cm, dy, hs,
                                                    gs, decay, sums, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int PN = d.P * d.N;
  ssd_bwd_pass_kernel<<<dim3((PN + kThreads - 1) / kThreads, a.B * d.H, 2),
                        kThreads, 0, a.stream>>>(
      hs, gs, decay, static_cast<const float*>(a.gT), d.nT, PN);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  constexpr size_t s3 = TileSmem<F32, KP, KN>::kBytes;
  if ((err = set_smem(ssd_bwd_tile_kernel<F32, KP, KN>, s3))) return err;
  ssd_bwd_tile_kernel<F32, KP, KN><<<dim3(d.nT, d.G * d.nhb, a.B), kTileThreads,
                                      s3, a.stream>>>(
      xdt, dA, Bm, Cm, dy, hs, gs, sums, static_cast<E*>(a.dx),
      static_cast<float*>(a.ddA), dBp, dCp, d);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int64_t per_group = static_cast<int64_t>(d.S) * d.N;
  const int64_t n_out = static_cast<int64_t>(a.B) * d.G * per_group;
  ssd_bwd_group_sum_kernel<E><<<static_cast<unsigned>(
                                    (n_out + kThreads - 1) / kThreads),
                                kThreads, 0, a.stream>>>(
      dBp, dCp, static_cast<E*>(a.dB), static_cast<E*>(a.dC), per_group,
      d.nhb, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool F32>
int by_size(const Args& a) {
  const Shape& d = a.d;
  if (d.P <= 64 && d.N <= 64) return run<F32, 64, 64>(a);
  if (d.P <= 64) return run<F32, 64, 128>(a);
  return run<F32, 128, 128>(a);
}

int launch(bool is_bf16, const Args& base, int64_t B, int64_t H, int64_t G,
           int64_t S, int64_t P, int64_t N, int64_t chunk) {
  if (B == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || S <= 0 || S > INT32_MAX / kMaxPN ||
      chunk <= 0 || S % chunk != 0 || P <= 0 || P > kMaxPN || N <= 0 ||
      N > kMaxPN || B > 65535 || H > 65535 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rep = H / G;
  Args a = base;
  a.B = static_cast<int>(B);
  a.d = Shape{static_cast<int>(H),     static_cast<int>(G),
              static_cast<int>(S),     static_cast<int>(P),
              static_cast<int>(N),     static_cast<int>(chunk < kT ? chunk : kT),
              static_cast<int>(tiles(S, chunk)),
              static_cast<int>(heads_per_block(rep)),
              static_cast<int>(blocks_per_group(rep))};
  if (G * a.d.nhb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? by_size<false>(a) : by_size<true>(a);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// float32 elements of the scratch the backward needs at this shape: each
// tile's cumulative sums of dA and their exponentials (B, H, tiles, 4,
// 64), the tile states twice (B, H, tiles, P, N), the tile decays (B, H,
// tiles) and the tile blocks' dB and dC partials (B, G
// blocks_per_group(H / G), S, N) each
int64_t ssd_scan_bwd_scratch_floats(int64_t B, int64_t H, int64_t G,
                                    int64_t S, int64_t P, int64_t N,
                                    int64_t chunk) {
  if (chunk <= 0 || G <= 0 || H % G != 0) return 0;
  const int64_t nT = tiles(S, chunk);
  return B * H * nT * (2 * P * N + 1 + 4 * kT) +
         2 * B * G * blocks_per_group(H / G) * S * N;
}

// xdt, dy, dxdt (B, H, S, P) and B, C, dB, dC (B, G, S, N) in one type;
// dA, ddA (B, H, S) float32; gT null or (B, H, P, N) float32, the final
// state's gradient; scratch ssd_scan_bwd_scratch_floats(...) floats.  All
// contiguous.  Four launches.
int ssd_scan_bwd_f32(const void* xdt, const void* dA, const void* Bm,
                     const void* Cm, const void* dy, const void* gT,
                     void* scratch, void* dxdt, void* ddA, void* dB, void* dC,
                     int64_t B, int64_t H, int64_t G, int64_t S, int64_t P,
                     int64_t N, int64_t chunk, void* stream) {
  const Args a{xdt, dA, Bm, Cm, dy, gT, static_cast<float*>(scratch),
               dxdt, ddA, dB, dC, 0, Shape{}, static_cast<cudaStream_t>(stream)};
  return launch(false, a, B, H, G, S, P, N, chunk);
}

int ssd_scan_bwd_bf16(const void* xdt, const void* dA, const void* Bm,
                      const void* Cm, const void* dy, const void* gT,
                      void* scratch, void* dxdt, void* ddA, void* dB,
                      void* dC, int64_t B, int64_t H, int64_t G, int64_t S,
                      int64_t P, int64_t N, int64_t chunk, void* stream) {
  const Args a{xdt, dA, Bm, Cm, dy, gT, static_cast<float*>(scratch),
               dxdt, ddA, dB, dC, 0, Shape{}, static_cast<cudaStream_t>(stream)};
  return launch(true, a, B, H, G, S, P, N, chunk);
}

}  // extern "C"
