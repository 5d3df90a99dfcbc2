// Mamba2 SSD chunked scan on Hopper.
//
// Replaces the Pallas TPU kernel `ssd_scan_tpu`
// (src/repro/kernels/ssd_scan/kernel.py, body `_ssd_kernel`).  For each
// (b, h), over the sequence in chunks of Q rows, with cs = cumsum(dA) within
// the chunk:
//
//   L[i, j] = exp(cs[i] - cs[j])  for j <= i, 0 above the diagonal
//   y       = (C B^T o L) xdt + (C o exp(cs)) state^T
//   state  <- exp(cs[Q-1]) state + (xdt o exp(cs[Q-1] - cs))^T B
//
// for xdt (B, H, S, P) (x pre-multiplied by dt), dA (B, H, S) float32,
// B/C (B, G, S, N); head h reads group h / (H / G).  The state starts at
// zero and is kept in float32; y is stored in xdt's type and the final state
// (B, H, P, N) in float32.  Inputs are converted to float32 on load.  The
// exponential is computed only where j <= i: above the diagonal cs[i] - cs[j]
// is positive and exp may overflow (the TPU kernel masks it with `where`
// after computing it).
//
// What bounds it: operations.  Counted for the chunked form at a tile of
// Q rows, as the lower triangle of C B^T once per (b, group, tile) (the
// heads of a group share it) and, per (b, h, tile), its product with xdt,
// the carry-in product and the state update (Q P N each) and the state's
// decay (P N), the function needs the least at Q 8: at mamba2-2.7b's main
// shape (B 2, H 80, G 1, S 2048, P 64, N 128) 11.3 GFLOP, 0.168 ms at the
// card's non-tensor float32 rate (12.2 GFLOP, 0.182 ms at this kernel's
// tile of 64; 13.5 GFLOP as the one-token recurrence), against 178.5 MB of
// inputs and outputs in float32, 0.053 ms at its memory rate.  This first
// version runs on the CUDA cores in float32 (no tensor cores), so that
// rate is its roof.
//
// Design.  The TPU walks the chunks on a sequential grid axis with the
// running (P, N) state in VMEM scratch; blocks on Hopper run in no order, so
// one block owns one (b, h) and loops over the chunks itself, with the state
// resident in shared memory across the loop.  Per chunk the block stages
// xdt, B, C and dA in shared memory as float32 (rows past S are zero, with
// dA 0, so they neither decay nor add to the state), one thread forms the
// cumulative sums, and 256 threads as a 16 x 16 grid run three products,
// each thread holding a register tile of its outputs:
//
//   scores  (Q x Q)  rows 4 ty .. 4 ty + 3, columns tx + 16 j;  masked and
//                    decayed in registers, staged in shared memory;
//   y       (Q x P)  the same rows, columns tx + 16 c: the carry-in product
//                    against the state, scaled by exp(cs[i]), then the
//                    intra-chunk product, one store per element;
//   state   (P x N)  rows ty + 16 a, columns tx + 16 c, after the xdt rows
//                    are scaled by exp(cs[Q-1] - cs[j]) in place.
//
// Rows of B and of the state are padded to N + 1 floats, so the column
// reads of the score and carry-in products are free of bank conflicts.
//
// Shared memory is (T P + 2 T (N + 1) + T T + P (N + 1) + T) floats for a
// row tile of T = min(chunk, 64): 129 KB at the main shape, 177 KB at
// P = N = 128.  A chunk above 64 rows is walked in tiles of 64 (the scan's
// result does not depend on where the sequence is cut; only the rounding
// does), so the entry point's default chunk of 128 stays under the 227 KB a
// block may have.  P and N may be 1 .. 128, the chunk 1 .. S.  Two
// instances a type: mamba2's P 64, N 128 holds 4 columns of P and 8 of N a
// thread, and one that holds 8 and 8 serves every other P, N <= 128 with
// its idle columns predicated off.
//
// The grid is (H, B): 160 blocks at the main shape, one per SM at this
// shared-memory size, on 132 SMs, so 28 SMs take a second block.  The
// chunk-parallel form (intra-chunk products and chunk states for all chunks
// in parallel, then a short scan over the chunk states) is the redesign.
// The C entry points return the CUDA error code of the launch so the Python
// wrapper raises on a refused launch; the kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kMaxT = 64;      // rows of a tile: 4 per thread row
constexpr int kMaxPN = 128;    // P and N: 8 columns per thread column

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline size_t smem_floats(int T, int P, int N) {
  return static_cast<size_t>(T) * P + 2ull * T * (N + 1) +
         static_cast<size_t>(T) * T + static_cast<size_t>(P) * (N + 1) + T;
}

// PC >= ceil(P / 16) and NC >= ceil(N / 16): the columns of P and of N each
// thread holds.
template <typename T, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    T* __restrict__ y, float* __restrict__ st_out, int H,
                    int G, int S, int P, int N, int Tq) {
  extern __shared__ float smem[];
  const int ldb = N + 1;             // B, C and state rows
  float* Xs = smem;                  // Tq x P
  float* Bs = Xs + Tq * P;           // Tq x (N + 1)
  float* Cs = Bs + Tq * ldb;         // Tq x (N + 1)
  float* Ss = Cs + Tq * ldb;         // Tq x Tq
  float* St = Ss + Tq * Tq;          // P x (N + 1)
  float* cs = St + P * ldb;          // Tq

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);

  const T* xb = xdt + static_cast<int64_t>(b * H + h) * S * P;
  const float* ab = dA + static_cast<int64_t>(b * H + h) * S;
  const T* bb = Bm + static_cast<int64_t>(b * G + g) * S * N;
  const T* cb = Cm + static_cast<int64_t>(b * G + g) * S * N;
  T* yb = y + static_cast<int64_t>(b * H + h) * S * P;

  for (int e = tid; e < P * N; e += kThreads)
    St[(e / N) * ldb + e % N] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Tq) {
    const int rows = min(Tq, S - s0);
    __syncthreads();  // the previous tile's operands are consumed
    for (int e = tid; e < Tq * P; e += kThreads) {
      const int r = e / P;
      Xs[e] = r < rows ? to_f32(xb[static_cast<int64_t>(s0) * P + e]) : 0.f;
    }
    for (int e = tid; e < Tq * N; e += kThreads) {
      const int r = e / N, c = e % N;
      const int64_t src = static_cast<int64_t>(s0) * N + e;
      Bs[r * ldb + c] = r < rows ? to_f32(bb[src]) : 0.f;
      Cs[r * ldb + c] = r < rows ? to_f32(cb[src]) : 0.f;
    }
    if (tid < Tq) cs[tid] = tid < rows ? ab[s0 + tid] : 0.f;
    __syncthreads();
    if (tid == 0) {  // cumulative sums, in sequence order
      float run = 0.f;
      for (int i = 0; i < Tq; ++i) {
        run += cs[i];
        cs[i] = run;
      }
    }
    __syncthreads();

    // scores[i][j] = (C_i . B_j) exp(cs[i] - cs[j]) for j <= i, else 0
    {
      float s[4][kMaxT / 16];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < kMaxT / 16; ++j) s[a][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[kMaxT / 16];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ty + a;
          cv[a] = i < Tq ? Cs[i * ldb + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kMaxT / 16; ++j) {
          const int jj = tx + 16 * j;
          bv[j] = jj < Tq ? Bs[jj * ldb + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < kMaxT / 16; ++j)
            s[a][j] = fmaf(cv[a], bv[j], s[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ty + a;
        if (i >= Tq) continue;
#pragma unroll
        for (int j = 0; j < kMaxT / 16; ++j) {
          const int jj = tx + 16 * j;
          if (jj >= Tq) continue;
          Ss[i * Tq + jj] = jj <= i ? s[a][j] * expf(cs[i] - cs[jj]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y[i][p] = exp(cs[i]) (C_i . state_p) + sum_j scores[i][j] xdt[j][p]
    {
      float acc[4][PC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ty + a;
          cv[a] = i < Tq ? Cs[i * ldb + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? St[p * ldb + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c)
            acc[a][c] = fmaf(cv[a], sv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ty + a;
        const float e = i < Tq ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[a][c] *= e;
      }
      for (int j = 0; j < Tq; ++j) {
        float sv[4], xv[PC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = 4 * ty + a;
          sv[a] = i < Tq ? Ss[i * Tq + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          xv[c] = p < P ? Xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < PC; ++c)
            acc[a][c] = fmaf(sv[a], xv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * ty + a;
        if (i >= rows) continue;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          if (p < P)
            store(yb + static_cast<int64_t>(s0 + i) * P + p, acc[a][c]);
        }
      }
    }
    __syncthreads();  // the state and xdt are read for y

    // xdt rows decayed to the end of the tile
    const float last = cs[Tq - 1];
    for (int e = tid; e < Tq * P; e += kThreads)
      Xs[e] *= expf(last - cs[e / P]);
    __syncthreads();

    // state[p][n] = exp(cs[T-1]) state[p][n] + sum_j xdt'[j][p] B[j][n]
    {
      const float keep = expf(last);
      float acc[PC][NC];
#pragma unroll
      for (int a = 0; a < PC; ++a) {
        const int p = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          acc[a][c] = p < P && n < N ? keep * St[p * ldb + n] : 0.f;
        }
      }
      for (int j = 0; j < Tq; ++j) {
        float xv[PC], bv[NC];
#pragma unroll
        for (int a = 0; a < PC; ++a) {
          const int p = ty + 16 * a;
          xv[a] = p < P ? Xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          bv[c] = n < N ? Bs[j * ldb + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < PC; ++a)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < PC; ++a) {
        const int p = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          if (p < P && n < N) St[p * ldb + n] = acc[a][c];
        }
      }
    }
  }
  __syncthreads();

  float* sb = st_out + static_cast<int64_t>(b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    sb[e] = St[(e / N) * ldb + e % N];
}

struct Args {
  const void *xdt, *dA, *Bm, *Cm;
  void *y, *st;
  int B, H, G, S, P, N, Tq;
  cudaStream_t stream;
};

template <typename T, int PC, int NC>
int run(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats(a.Tq, a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PC, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.H, a.B);
  ssd_scan_kernel<T, PC, NC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.xdt), static_cast<const float*>(a.dA),
      static_cast<const T*>(a.Bm), static_cast<const T*>(a.Cm),
      static_cast<T*>(a.y), static_cast<float*>(a.st), a.H, a.G, a.S, a.P,
      a.N, a.Tq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xdt, const void* dA, const void* Bm, const void* Cm,
           void* y, void* st, int64_t B, int64_t H, int64_t G, int64_t S,
           int64_t P, int64_t N, int64_t chunk, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (G <= 0 || H % G != 0 || S <= 0 || S > INT32_MAX / kMaxPN ||
      chunk <= 0 || S % chunk != 0 || P <= 0 || P > kMaxPN || N <= 0 ||
      N > kMaxPN || B > 65535 || H > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{xdt, dA, Bm, Cm, y, st,
               static_cast<int>(B), static_cast<int>(H), static_cast<int>(G),
               static_cast<int>(S), static_cast<int>(P), static_cast<int>(N),
               static_cast<int>(chunk < kMaxT ? chunk : kMaxT),
               static_cast<cudaStream_t>(stream)};
  if ((a.P + 15) / 16 == 4 && (a.N + 15) / 16 == 8) return run<T, 4, 8>(a);
  return run<T, 8, 8>(a);
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xdt (B, H, S, P), B/C (B, G, S, N) in one type, dA (B, H, S) float32 ->
// y (B, H, S, P) in that type, st (B, H, P, N) float32; all contiguous.
int ssd_scan_f32(const void* xdt, const void* dA, const void* Bm,
                 const void* Cm, void* y, void* st, int64_t B, int64_t H,
                 int64_t G, int64_t S, int64_t P, int64_t N, int64_t chunk,
                 void* stream) {
  return launch<float>(xdt, dA, Bm, Cm, y, st, B, H, G, S, P, N, chunk,
                       stream);
}

int ssd_scan_bf16(const void* xdt, const void* dA, const void* Bm,
                  const void* Cm, void* y, void* st, int64_t B, int64_t H,
                  int64_t G, int64_t S, int64_t P, int64_t N, int64_t chunk,
                  void* stream) {
  return launch<__nv_bfloat16>(xdt, dA, Bm, Cm, y, st, B, H, G, S, P, N,
                               chunk, stream);
}

}  // extern "C"
