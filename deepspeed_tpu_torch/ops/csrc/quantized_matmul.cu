// Int8 weight matmuls for Hopper (sm_90a): the w8a8 decode product with
// in-kernel activation quantization, on one weight or on layer `idx` of a
// resident stack, and the weight-only int8 product with bf16 dequantization.
//
// Entry points and the TPU kernels they replace
// (deepspeed_tpu/ops/quantized_matmul.py):
//   ds_w8a8_matmul          <- _w8a8_call (_w8a8_kernel): x [B<=8, K] float,
//                              qk int8 [K, N], kscale f32 [K/G, 1, N]
//   ds_w8a8_matmul_stacked  <- _w8a8_stacked_call (_w8a8_stacked_kernel): the
//                              same on layer *idx of qk [L, K, N], kscale
//                              [L, K/G, 1, N]; idx is an int32 in device
//                              memory (the TPU's scalar prefetch), read by
//                              the kernel, clamped to [0, L) as a dynamic
//                              index is
//   ds_quantized_matmul     <- _qmm_call (_kernel): x [M, K] float, q int8
//                              [K, N], scale f32 [K, N/G], G % 128 == 0
// Every one returns cudaGetLastError() after its launch.
//
// w8a8 arithmetic (quantized_matmul.py:249-263, kept literally): for each
// k-group of G rows, in order, each row's ax = max|x| in f32 (0 read as 1),
// codes xq = clip(rint(x * (127 / ax)), -127, 127), the exact int32 dot of
// the codes with the int8 weight column, and acc += (float(dot) * (ax /
// 127)) * kscale[n] in f32; one cast at the end.  The multiplies and adds
// are the _rn intrinsics so nvcc cannot contract them into FMAs, and rintf
// rounds half to even as jnp.round does.
//
// w8a8 design.  One block of 256 threads per 32 output columns, all rows
// (B <= 8) and all of K; grid N/32.  Per k-group the block quantizes the
// activations into shared memory (128 k-rows at a time), and its threads
// split the group's k-rows 32 ways, each thread reading 4 weight columns as
// one 32-bit load and keeping 8 rows x 4 columns of int32 partial dots.  The
// 32 partials of a column are summed in shared memory (an exact integer sum,
// so its order is free), and the thread that owns (row, column) adds the
// group's scaled term to its f32 accumulator.  A row's result depends on no
// other row, whatever B is.  Bound: the weight bytes (K*N int8 + K/G*N f32
// scales) over 3.35 TB/s; 2*B*K*N int8 operations are far below the
// tensor cores' rate at B <= 8.  Known limit: the 32-column tiles give few
// blocks (24 at N=768), no copy/compute overlap, and the dot runs on the
// integer ALUs, not the int8 tensor cores.
//
// Weight-only arithmetic (quantized_matmul.py:91-98): out = sum_k bf16(x) *
// bf16(bf16(q) * bf16(scale[k, n/G])) with f32 accumulation; the weight's
// product rounds to bf16 as the TPU kernel's bf16 multiply does.  Design:
// 32 x 64 output tiles, 256 threads of 2 x 4 outputs each, k in steps of 32
// staged in shared memory as f32 (x rounded to bf16, weights dequantized);
// each output sums k in order, so rows are independent of M.  Bound: the
// int8 weight bytes plus scales.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
};
template <> struct Cvt<__half> {
  __device__ static float in(__half x) { return __half2float(x); }
  __device__ static __half out(float x) { return __float2half_rn(x); }
};
template <> struct Cvt<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// byte c (0..3) of a 32-bit word as a signed int
__device__ __forceinline__ int sbyte(int w, int c) {
  return ((int)((unsigned)w << (24 - 8 * c))) >> 24;
}

constexpr int W8_THREADS = 256;
constexpr int W8_ROWS = 8;                       // W8A8_MAX_ROWS
constexpr int W8_TN = 32;                        // output columns per block
constexpr int W8_CPT = 4;                        // columns per thread
constexpr int W8_TX = W8_TN / W8_CPT;            // 8 column lanes
constexpr int W8_TY = W8_THREADS / W8_TX;        // 32 k-slices
constexpr int W8_KC = 128;                       // k-rows of codes staged

template <typename TX, typename TO>
__global__ void __launch_bounds__(W8_THREADS)
w8a8_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qk,
            const float* __restrict__ kscale, const int* __restrict__ layer,
            TO* __restrict__ out, int L, int B, int K, int N, int G) {
  __shared__ int part[W8_TY][W8_ROWS][W8_TN];
  __shared__ __align__(8) int8_t xq[W8_KC][W8_ROWS];   // [k][row]
  __shared__ float ax[W8_ROWS];

  const int tid = threadIdx.x;
  const int tx = tid % W8_TX, ty = tid / W8_TX;
  const int warp = tid / 32, lane = tid % 32;
  const int ob = tid / W8_TN, oc = tid % W8_TN;       // owned output
  const int n0 = blockIdx.x * W8_TN;
  if (layer != nullptr) {
    const int l = min(max(*layer, 0), L - 1);
    qk += (size_t)l * K * N;
    kscale += (size_t)l * (K / G) * N;
  }
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += G) {
    if (warp < B) {                                    // one warp per row
      float m = 0.f;
      for (int i = lane; i < G; i += 32)
        m = fmaxf(m, fabsf(Cvt<TX>::in(x[(size_t)warp * K + k0 + i])));
      m = warp_max(m);
      if (lane == 0) ax[warp] = m == 0.f ? 1.f : m;
    }
    int p[W8_ROWS][W8_CPT];
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < W8_CPT; ++c) p[r][c] = 0;
    for (int c0 = 0; c0 < G; c0 += W8_KC) {
      const int kc = min(W8_KC, G - c0);
      __syncthreads();                  // ax written; last chunk consumed
      for (int i = tid; i < W8_KC * W8_ROWS; i += W8_THREADS) {
        const int kk = i / W8_ROWS, r = i % W8_ROWS;
        int8_t code = 0;
        if (r < B && kk < kc) {
          const float xv = Cvt<TX>::in(x[(size_t)r * K + k0 + c0 + kk]);
          const float qv = rintf(__fmul_rn(xv, __fdiv_rn(127.f, ax[r])));
          code = (int8_t)fminf(fmaxf(qv, -127.f), 127.f);
        }
        xq[kk][r] = code;
      }
      __syncthreads();
      for (int kk = ty; kk < kc; kk += W8_TY) {
        const int w = *reinterpret_cast<const int*>(
            qk + (size_t)(k0 + c0 + kk) * N + n0 + tx * W8_CPT);
        const int2 xr = *reinterpret_cast<const int2*>(&xq[kk][0]);
        int wc[W8_CPT];
#pragma unroll
        for (int c = 0; c < W8_CPT; ++c) wc[c] = sbyte(w, c);
#pragma unroll
        for (int r = 0; r < W8_ROWS; ++r) {
          const int xv = sbyte(r < 4 ? xr.x : xr.y, r % 4);
#pragma unroll
          for (int c = 0; c < W8_CPT; ++c) p[r][c] += xv * wc[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < W8_ROWS; ++r)
#pragma unroll
      for (int c = 0; c < W8_CPT; ++c) part[ty][r][tx * W8_CPT + c] = p[r][c];
    __syncthreads();
    if (ob < B) {
      int dot = 0;
      for (int y = 0; y < W8_TY; ++y) dot += part[y][ob][oc];
      const float term = __fmul_rn(__fmul_rn((float)dot,
                                             __fdiv_rn(ax[ob], 127.f)),
                                   kscale[(size_t)(k0 / G) * N + n0 + oc]);
      acc = __fadd_rn(acc, term);
    }
    __syncthreads();                    // part and ax are reused
  }
  if (ob < B) out[(size_t)ob * N + n0 + oc] = Cvt<TO>::out(acc);
}

constexpr int QM_THREADS = 256;
constexpr int QM_TM = 32, QM_TN = 64, QM_TK = 32;

template <typename TX, typename TO>
__global__ void __launch_bounds__(QM_THREADS)
qmm_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, TO* __restrict__ out, int M,
           int K, int N, int G) {
  __shared__ float xs[QM_TK][QM_TM + 1];             // [k][row]
  __shared__ float ws[QM_TK][QM_TN];                 // [k][column]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;            // 4 columns x 2 rows
  const int m0 = blockIdx.y * QM_TM, n0 = blockIdx.x * QM_TN;
  const int ng = N / G;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += QM_TK) {
    for (int i = tid; i < QM_TM * QM_TK; i += QM_THREADS) {
      const int m = i / QM_TK, kk = i % QM_TK;
      float v = 0.f;
      if (m0 + m < M && k0 + kk < K)
        v = __bfloat162float(__float2bfloat16_rn(
            Cvt<TX>::in(x[(size_t)(m0 + m) * K + k0 + kk])));
      xs[kk][m] = v;
    }
    for (int i = tid; i < QM_TK * QM_TN; i += QM_THREADS) {
      const int kk = i / QM_TN, n = i % QM_TN;
      float w = 0.f;
      if (k0 + kk < K) {
        const size_t k = (size_t)(k0 + kk);
        const float qb = (float)q[k * N + n0 + n];    // exact in bf16
        const float sb = __bfloat162float(
            __float2bfloat16_rn(scale[k * ng + (n0 + n) / G]));
        w = __bfloat162float(__float2bfloat16_rn(__fmul_rn(qb, sb)));
      }
      ws[kk][n] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < QM_TK; ++kk) {
      const float a0 = xs[kk][ty * 2], a1 = xs[kk][ty * 2 + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = ws[kk][tx * 4 + c];
        acc[0][c] += a0 * b;                         // products are exact
        acc[1][c] += a1 * b;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m < M)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(size_t)m * N + n0 + tx * 4 + c] = Cvt<TO>::out(acc[i][c]);
  }
}

template <typename TX, typename TO>
int launch_w8a8(const void* layer, const void* x, const void* qk,
                const void* kscale, void* out, int L, int B, int K, int N,
                int G, void* stream) {
  if (B < 1 || B > W8_ROWS || G < 1 || K % G || N % W8_TN)
    return (int)cudaErrorInvalidValue;
  w8a8_kernel<TX, TO><<<N / W8_TN, W8_THREADS, 0, (cudaStream_t)stream>>>(
      (const TX*)x, (const int8_t*)qk, (const float*)kscale,
      (const int*)layer, (TO*)out, L, B, K, N, G);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch_qmm(const void* x, const void* q, const void* scale, void* out,
               int M, int K, int N, int G, void* stream) {
  if (M < 1 || G < 1 || N % G || N % QM_TN) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / QM_TN, (M + QM_TM - 1) / QM_TM);
  qmm_kernel<TX, TO><<<grid, QM_THREADS, 0, (cudaStream_t)stream>>>(
      (const TX*)x, (const int8_t*)q, (const float*)scale, (TO*)out, M, K, N,
      G);
  return (int)cudaGetLastError();
}

// dtype codes: 0 float32, 1 float16, 2 bfloat16; an unknown pair returns
// cudaErrorInvalidValue (the Python wrappers check first).
#define DS_DTYPE_SWITCH(CODE, TYPE, ...)                   \
  switch (CODE) {                                          \
    case 0: { using TYPE = float; __VA_ARGS__ }            \
    case 1: { using TYPE = __half; __VA_ARGS__ }           \
    case 2: { using TYPE = __nv_bfloat16; __VA_ARGS__ }    \
    default: return (int)cudaErrorInvalidValue;            \
  }

}  // namespace

extern "C" {

int ds_w8a8_matmul(const void* x, const void* qk, const void* kscale,
                   void* out, int B, int K, int N, int G, int x_dtype,
                   int out_dtype, void* stream) {
  DS_DTYPE_SWITCH(x_dtype, TX, DS_DTYPE_SWITCH(out_dtype, TO,
      return launch_w8a8<TX, TO>(nullptr, x, qk, kscale, out, 1, B, K, N, G,
                                 stream);))
}

int ds_w8a8_matmul_stacked(const void* layer, const void* x, const void* qks,
                           const void* kscales, void* out, int L, int B,
                           int K, int N, int G, int x_dtype, int out_dtype,
                           void* stream) {
  DS_DTYPE_SWITCH(x_dtype, TX, DS_DTYPE_SWITCH(out_dtype, TO,
      return launch_w8a8<TX, TO>(layer, x, qks, kscales, out, L, B, K, N, G,
                                 stream);))
}

int ds_quantized_matmul(const void* x, const void* q, const void* scale,
                        void* out, int M, int K, int N, int G, int x_dtype,
                        int out_dtype, void* stream) {
  DS_DTYPE_SWITCH(x_dtype, TX, DS_DTYPE_SWITCH(out_dtype, TO,
      return launch_qmm<TX, TO>(x, q, scale, out, M, K, N, G, stream);))
}

}  // extern "C"
