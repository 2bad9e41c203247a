// Decode attention over a KV cache for Hopper (sm_90a): one query token, or
// a window of up to 16, per row against a contiguous cache or a block-paged
// pool (float, or int8 codes with per-token bf16 scales), with an f32
// online softmax.
//
// Entry points and the TPU kernels they replace
// (deepspeed_tpu/ops/decode_attention.py):
//   ds_paged_decode_attention    <- paged_decode_attention_pallas
//                                   (_paged_decode_kernel): q [B,H,1,D] vs pool
//                                   [NB,HKV,bs,D] through int32 [B,NBPER] tables
//   ds_paged_verify_attention    <- paged_verify_attention_pallas
//                                   (_paged_verify_kernel): q [B,H,T,D], T <= 16,
//                                   row i of the window at position pos[b] + i
//   ds_paged_decode_attention_q8 <- the same two kernels on an int8 pool
//   ds_paged_verify_attention_q8    (_paged_pool_operands, quant=True): codes
//                                   int8 [NB,HKV,bs,D] plus scales bf16
//                                   [NB,HKV,bs] for K and for V
//   ds_decode_attention          <- decode_attention_pallas (_decode_kernel):
//                                   q [B,H,1,D] vs cache [B,HKV,S,D]
// Every one returns cudaGetLastError() after its launch.
//
// Design.  One thread block per (row b, KV head g); grid (HKV, B).  The
// R = rep*T query rows that share the KV head (row r: head g*rep + r/T,
// window offset r%T) sit in shared memory as f32.  The TPU kernel's
// sequential grid axis over KV chunks becomes a loop inside the block over
// 32-key tiles from key 0 up to the last key any row may see
// (pos[b] + T - 1, capped at the cache length), so tiles past a row's valid
// prefix are never read.  A paged key's address is looked up in the row's
// block table; negative entries clamp to scratch block 0, as in the TPU
// kernel.  Per tile: the threads load K and V with 16-byte vector loads
// into shared memory (f32), threads split the R x 32 scores, one warp per
// query row runs the online-softmax update of the TPU kernel (masking with
// NEG_INF past key pos[b] + r%T), and threads split the R x D accumulator.
// The finish divides by l, with l == 0 read as 1.
//
// int8 pools.  The tile holds the integer codes (as f32) and each key's K
// and V scale; the scales fold into the columns as in the TPU kernel
// (decode_attention.py:169-190): s = (q . code_k) * sm_scale * ks[j], and
// the probability multiplies vs[j] before the P V product, while the online
// softmax's m and l stay over the unscaled probabilities.  No dequantized
// tile is ever written to device memory.
//
// Bound.  Per call the kernel must read the valid keys and values once:
// sum_b (pos_b + T) * HKV * (D * sizeof(kv) [+ 2 scale bytes]) * 2 bytes,
// plus q and out; the arithmetic is 4*R*D flops per key, far below the
// card's 295 flops/byte balance point, so the H100's 3.35 TB/s is the bound.
//
// Known limit.  The grid is B*HKV blocks with no split over the KV length:
// at the serving path's 8 slots x 12 KV heads that is 96 blocks for 132
// SMs, each block streaming its whole prefix alone, with four barriers
// per 32-key tile and no copy/compute overlap.  A split-K (flash-decoding)
// grid with cp.async or TMA double buffering is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KT = 32;          // keys per tile: one per lane in the softmax
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static float store(float x) { return x; }
};

template <> struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static __half store(float x) { return __float2half(x); }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x; o[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

template <> struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* o) {
    const int4 u = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (float)c[i];
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kv: contiguous [B, HKV, S, D] (PAGED false) or pool [NB, HKV, bs, D] read
// through block_tables [B, nbper] (PAGED true).  KV is T, or int8_t for an
// int8 pool (PAGED only), whose per-token scales k_scale / v_scale are
// [NB, HKV, bs] bf16.  q/out: [B, H, T, D], whose (b, g) slice is the
// contiguous [R, D] run at ((b*HKV + g) * R) * D.
template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
attn_kernel(const T* __restrict__ q, const KV* __restrict__ k,
            const KV* __restrict__ v, const __nv_bfloat16* __restrict__ k_scale,
            const __nv_bfloat16* __restrict__ v_scale,
            const int* __restrict__ block_tables,
            const int* __restrict__ pos, T* __restrict__ out, int H, int HKV,
            int win, int S, int bs, int nbper, float scale) {
  constexpr bool QUANT = !std::is_same<T, KV>::value;
  static_assert(!QUANT || PAGED, "int8 KV is a paged pool");
  constexpr int VN = Vec<T>::N;
  constexpr int DV = D / VN;
  constexpr int KVN = Vec<KV>::N;
  constexpr int KDV = D / KVN;
  const int g = blockIdx.x, b = blockIdx.y;
  const int R = (H / HKV) * win;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                  // [R, D]
  float* acc = qs + R * D;           // [R, D]
  float* ks = acc + R * D;           // [KT, D + 1] (padded: conflict-free dots)
  float* vs = ks + KT * (D + 1);     // [KT, D]
  float* ps = vs + KT * D;           // [R, KT] scores, then probabilities
  float* m = ps + R * KT;            // [R] running max
  float* l = m + R;                  // [R] running sum
  float* alpha = l + R;              // [R] this tile's rescale factor
  float* ksc = alpha + R;            // [KT] int8 pools: the tile's K scales
  float* vsc = ksc + KT;             // [KT] and V scales

  const size_t qoff = ((size_t)b * HKV + g) * (size_t)R * D;
  for (int i = tid; i < R * DV; i += NTHREADS) {
    float t[VN];
    Vec<T>::load(q + qoff + (size_t)i * VN, t);
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[i * VN + e] = t[e];
  }
  for (int i = tid; i < R * D; i += NTHREADS) acc[i] = 0.f;
  for (int r = tid; r < R; r += NTHREADS) { m[r] = NEG_INF; l[r] = 0.f; }

  const int base = pos[b];
  const int cap = PAGED ? nbper * bs : S;
  const int nkeys = max(0, min(base + win, cap));   // keys 0 .. nkeys-1
  __syncthreads();

  for (int t0 = 0; t0 < nkeys; t0 += KT) {
    for (int i = tid; i < KT * KDV; i += NTHREADS) {
      const int j = i / KDV, c = (i % KDV) * KVN, key = t0 + j;
      float kt[KVN], vt[KVN];
      if (key < nkeys) {
        size_t off;
        if (PAGED) {
          const int blk = max(block_tables[(size_t)b * nbper + key / bs], 0);
          off = (((size_t)blk * HKV + g) * bs + key % bs) * D + c;
        } else {
          off = (((size_t)b * HKV + g) * S + key) * D + c;
        }
        Vec<KV>::load(k + off, kt);
        Vec<KV>::load(v + off, vt);
      } else {
#pragma unroll
        for (int e = 0; e < KVN; ++e) { kt[e] = 0.f; vt[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < KVN; ++e) {
        ks[j * (D + 1) + c + e] = kt[e];
        vs[j * D + c + e] = vt[e];
      }
    }
    if (QUANT && tid < KT) {
      const int key = t0 + tid;
      float a = 0.f, c = 0.f;
      if (key < nkeys) {
        const int blk = max(block_tables[(size_t)b * nbper + key / bs], 0);
        const size_t soff = ((size_t)blk * HKV + g) * bs + key % bs;
        a = __bfloat162float(k_scale[soff]);
        c = __bfloat162float(v_scale[soff]);
      }
      ksc[tid] = a;
      vsc[tid] = c;
    }
    __syncthreads();

    for (int i = tid; i < R * KT; i += NTHREADS) {
      const int r = i / KT, j = i % KT, key = t0 + j;
      float s = NEG_INF;
      if (key < nkeys && key <= base + r % win) {
        const float* qr = qs + r * D;
        const float* kr = ks + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = dot * scale;
        if (QUANT) s = __fmul_rn(s, ksc[j]);
      }
      ps[i] = s;
    }
    __syncthreads();

    for (int r = warp; r < R; r += NTHREADS / 32) {
      const float s = ps[r * KT + lane];
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = s > 0.5f * NEG_INF ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      ps[r * KT + lane] = QUANT ? p * vsc[lane] : p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < R * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const float* pr = ps + r * KT;
      float a = acc[i] * alpha[r];
#pragma unroll 8
      for (int j = 0; j < KT; ++j) a += pr[j] * vs[j * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += NTHREADS) {
    const float lr = l[i / D];
    out[qoff + i] = Vec<T>::store(acc[i] / (lr == 0.f ? 1.f : lr));
  }
}

size_t smem_bytes(int R, int D) {
  return ((size_t)2 * R * D + (size_t)KT * (D + 1) + (size_t)KT * D +
          (size_t)R * KT + 3 * (size_t)R + 2 * (size_t)KT) * sizeof(float);
}

template <typename T, typename KV, int D, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* bt, const void* pos, void* out,
           int B, int H, int HKV, int win, int S, int bs, int nbper,
           float scale, void* stream) {
  const size_t smem = smem_bytes((H / HKV) * win, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, KV, D, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attn_kernel<T, KV, D, PAGED><<<dim3(HKV, B), NTHREADS, smem,
                                 (cudaStream_t)stream>>>(
      (const T*)q, (const KV*)k, (const KV*)v,
      (const __nv_bfloat16*)k_scale, (const __nv_bfloat16*)v_scale,
      (const int*)bt, (const int*)pos, (T*)out, H, HKV, win, S, bs, nbper,
      scale);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 float16, 2 bfloat16 (of q and out; of the pool too
// unless Q8, whose pool holds int8 codes and bf16 scales).  D: 64 (GPT-2);
// another head dim is instantiated with the model family that needs it.
// Unsupported (dtype, D) pairs return cudaErrorInvalidValue; the Python
// wrapper checks them first.
template <bool PAGED, bool Q8>
int dispatch(int dtype, int D, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* bt,
             const void* pos, void* out, int B, int H, int HKV, int win,
             int S, int bs, int nbper, float scale, void* stream) {
#define DS_CASE(TYPE, DIM)                                                  \
  return launch<TYPE, typename std::conditional<Q8, int8_t, TYPE>::type,   \
                DIM, PAGED>(q, k, v, k_scale, v_scale, bt, pos, out, B, H, \
                            HKV, win, S, bs, nbper, scale, stream)
#define DS_DIMS(TYPE)                           \
  switch (D) {                                  \
    case 64: DS_CASE(TYPE, 64);                 \
    default: return (int)cudaErrorInvalidValue; \
  }
  switch (dtype) {
    case 0: DS_DIMS(float);
    case 1: DS_DIMS(__half);
    case 2: DS_DIMS(__nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DS_DIMS
#undef DS_CASE
}

}  // namespace

extern "C" {

size_t ds_attention_smem_bytes(int R, int D) { return smem_bytes(R, D); }

int ds_decode_attention(const void* q, const void* k, const void* v,
                        const void* pos, void* out, int B, int H, int HKV,
                        int S, int D, int dtype, float scale, void* stream) {
  return dispatch<false, false>(dtype, D, q, k, v, nullptr, nullptr, nullptr,
                                pos, out, B, H, HKV, 1, S, 1, 1, scale,
                                stream);
}

int ds_paged_decode_attention(const void* q, const void* k_pool,
                              const void* v_pool, const void* block_tables,
                              const void* pos, void* out, int B, int H,
                              int HKV, int bs, int nbper, int D, int dtype,
                              float scale, void* stream) {
  return dispatch<true, false>(dtype, D, q, k_pool, v_pool, nullptr, nullptr,
                               block_tables, pos, out, B, H, HKV, 1, 0, bs,
                               nbper, scale, stream);
}

int ds_paged_verify_attention(const void* q, const void* k_pool,
                              const void* v_pool, const void* block_tables,
                              const void* pos, void* out, int B, int H,
                              int HKV, int T, int bs, int nbper, int D,
                              int dtype, float scale, void* stream) {
  return dispatch<true, false>(dtype, D, q, k_pool, v_pool, nullptr, nullptr,
                               block_tables, pos, out, B, H, HKV, T, 0, bs,
                               nbper, scale, stream);
}

int ds_paged_decode_attention_q8(const void* q, const void* k_codes,
                                 const void* k_scale, const void* v_codes,
                                 const void* v_scale,
                                 const void* block_tables, const void* pos,
                                 void* out, int B, int H, int HKV, int bs,
                                 int nbper, int D, int dtype, float scale,
                                 void* stream) {
  return dispatch<true, true>(dtype, D, q, k_codes, v_codes, k_scale, v_scale,
                              block_tables, pos, out, B, H, HKV, 1, 0, bs,
                              nbper, scale, stream);
}

int ds_paged_verify_attention_q8(const void* q, const void* k_codes,
                                 const void* k_scale, const void* v_codes,
                                 const void* v_scale,
                                 const void* block_tables, const void* pos,
                                 void* out, int B, int H, int HKV, int T,
                                 int bs, int nbper, int D, int dtype,
                                 float scale, void* stream) {
  return dispatch<true, true>(dtype, D, q, k_codes, v_codes, k_scale, v_scale,
                              block_tables, pos, out, B, H, HKV, T, 0, bs,
                              nbper, scale, stream);
}

}  // extern "C"
