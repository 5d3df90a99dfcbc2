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
// computes what the reference's blocked algorithm computes.  The output is
// acc / max(l, 1e-30), cast to q's type.
//
// What bounds it: operations.  At the model's shape (B 2, H 9, S 2048,
// Dh 64, causal) it does 2 * 2 * Dh multiply-adds per visible (query, key)
// pair, about 9.7 GFLOP, against 12.6 MB of q, k, v and o in bfloat16.
// This first version runs on the CUDA cores in float32 (no tensor cores;
// float32 in full float32, not TF32), so its roof is the card's float32
// rate, far below the bfloat16 tensor-core rate the bound is stated at.
//
// Design.  The TPU kernel walks the key blocks as a sequential grid axis,
// carrying m, l and acc in VMEM scratch; blocks on Hopper run in parallel
// and in no order, so here one block owns one (b, h, 64-row query tile) and
// loops over 64-key tiles itself:
//
//   * the query tile, and per step one key and one value tile, are staged
//     in shared memory as float32 (bfloat16 is converted on load; rows past
//     Sq or Sk are zero).  Row strides of Dh + 1 floats keep the column
//     reads of the score product free of bank conflicts;
//   * 256 threads form a 16 x 16 grid: thread (ty, tx) owns query rows
//     4 ty .. 4 ty + 3, score columns tx + 16 j, and output columns
//     tx + 16 c.  The 16 threads of one row are 16 lanes of one warp, so
//     the row max and row sum are shuffle reductions (a butterfly, which
//     leaves the same value on every lane);
//   * running m, l and acc stay in float32 registers; the probabilities of
//     a tile go through shared memory to the P V product;
//   * key tiles wholly above the causal diagonal are never visited, and the
//     query tiles with the most work are scheduled first.
//
// Shared memory: (64 (Dh+1) + 64 (Dh+1) + 64 Dh + 64 * 65) floats, 66 KB at
// Dh 64 and 209 KB at Dh 256, set with cudaFuncSetAttribute above 48 KB.
// Dh is a template parameter: 16 (the reduced test configs), 32, 64, 96,
// 128, 192 and 256 are built.
// The C entry points return the CUDA error code of the launch so the
// Python wrapper raises on a refused launch; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Sk, int causal, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B,
             int64_t H, int64_t Hkv, int64_t Sq, int64_t Sk, int64_t Dh,
             int causal, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk);
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 96: return launch<T, 96>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 192: return launch<T, 192>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
    case 256: return launch<T, 256>(q, k, v, o, b, h, hkv, sq, sk, causal, s);
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
  return dispatch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int64_t B, int64_t H, int64_t Hkv,
                         int64_t Sq, int64_t Sk, int64_t Dh, int causal,
                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, Dh, causal,
                                 stream);
}

}  // extern "C"
