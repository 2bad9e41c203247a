// Decode attention over a KV cache for Hopper (sm_90a): one query token, or
// a window of up to 16, per row against a contiguous cache or a block-paged
// pool (float, or int8 codes with per-token bf16 scales), with an f32
// online softmax.
//
// Entry points and the TPU kernels they replace
// (deepspeed_tpu/ops/decode_attention.py):
//   ds_paged_verify_attention_split <- paged_verify_attention_pallas
//                                   (_paged_verify_kernel, T <= 16),
//                                   paged_decode_attention_pallas
//                                   (_paged_decode_kernel, T = 1) and
//                                   decode_attention_pallas (_decode_kernel,
//                                   a contiguous cache as a pool of one block
//                                   a row) on bf16 or fp16
//                                   K/V: q [B,H,T,D], row i of the
//                                   window at position pos[b] + i, against the
//                                   pool [NB,HKV,bs,D] through int32 [B,NBPER]
//                                   tables (verify_split_kernel)
//   ds_paged_attention_q8_split  <- paged_decode_attention_pallas
//                                   (_paged_decode_kernel, T = 1) and
//                                   paged_verify_attention_pallas
//                                   (_paged_verify_kernel, T <= 16) on an int8
//                                   pool (_paged_pool_operands, quant=True):
//                                   codes int8 [NB,HKV,bs,D] plus scales bf16
//                                   [NB,HKV,bs] for K and for V, bf16 or fp16
//                                   q (q8_split_kernel)
//   ds_paged_verify_attention    <- the verify kernel on an f32 pool
//                                   (attn_kernel)
//   ds_paged_decode_attention    <- the decode kernel on an f32 pool:
//                                   q [B,H,1,D] vs the pool (attn_kernel)
//   ds_paged_decode_attention_q8 <- the decode and verify kernels on an int8
//   ds_paged_verify_attention_q8    pool with f32 q (attn_kernel)
//   ds_decode_attention          <- the decode kernel on an f32 cache:
//                                   q [B,H,1,D] vs cache [B,HKV,S,D]
//                                   (attn_kernel)
// Every one returns cudaGetLastError() after its launch.
//
// Bound.  Per call a kernel must read the valid keys and values once:
// sum_b (pos_b + T) * HKV * (D * sizeof(kv) [+ 2 scale bytes]) * 2 bytes,
// plus q and out; the arithmetic is 4*R*D flops per key, far below the
// card's 295 flops/byte balance point, so the H100's 3.35 TB/s bounds them
// all.  At the serving path's shapes the whole call moves a few MB, so what
// decides its time is how many SMs stream keys at once and how long each
// waits on its loads.
//
// verify_split_kernel (split-K, flash-decoding; 16-bit pools: B4 windows
// and, at T = 1, the B3 decode).  Grid
// (nsplit, HKV, B): each block takes a fixed span of 128 keys of one row's
// KV head, so no block walks more than 128 keys whatever the row's length,
// and nsplit = ceil(NBPER * bs / 128) comes from the table's width on the
// host (no sync to learn the lengths); a block whose span starts past its
// row's last visible key exits at once.  Each of the 4 warps loads its 32
// keys of K and then V in their own 16-bit type with cp.async (16-byte
// copies into XOR-swizzled rows of D * 2 bytes, each key's block looked up
// in the table, so any bs works; -1 entries clamp to scratch block 0), and
// computes Q K^T on the tensor cores while V is still in flight:
// mma.sync.m16n8k16 (f32 accumulate) with ldmatrix for Q and K and
// ldmatrix.trans for V, the R = rep*T query rows in m16 tiles.  mma.sync,
// not wgmma: R <= 64 in 16-row granules is the shape mma.sync serves, and a
// 64-row wgmma would idle 3/4 of its rows at R = 16.  Each warp's softmax
// runs on its score fragments (exp2 domain, the per-row mask key <= pos[b]
// + r%T), P becomes the A operand in registers, and the warps merge their
// (m, l, O) through shared memory.  A row's partials (unnormalised O, m, l
// per split) go to scratch the wrapper allocates; the last block of each
// (b, g) to finish, by an atomic ticket that it resets for the next call
// (and a CUDA-graph replay), merges them by the log-sum-exp rule in split
// order, so results do not depend on which block finished last.  A row
// whose keys fit one split writes its output directly.
//
// Head dim D (64: GPT-2; 128: llama).  One body, split_attention<T, KV, D>,
// serves both: D sets the rows' width (D * 2 bytes of q, K and V a row, in
// D / 8 swizzled 16-byte chunks), the QK^T k-steps (D / 16), the PV n-tiles
// (D / 8) and the partials' width, and nothing else: a row's sums over
// keys, warps and splits run in the same order at any D.  At D = 128 a
// block stages 128 keys of K and of V (32 KB each), up to 64 query rows
// (16 KB at R = 64: llama's GQA rep 4 times a 16-token window) and the
// warps' f32 merge tiles (34 KB), 116 KB of the SM's 227; its accumulators
// double (64 registers of O a thread).  The bound doubles with D too: a
// bf16 key and value are 512 bytes.
//
// q8_split_kernel (int8 pools, bf16 or fp16 q; T = 1 decode and T <= 16
// windows).  The same grid, warps, products, softmax and merge as
// verify_split_kernel (one body, split_attention<T, KV>); what differs is
// how the keys arrive.  Bound: each key a row may see is read once as D
// codes plus a 2-byte scale, for K and for V: 2 * (D + 2) bytes a key
// against the bf16 pool's 4 * D, so the int8 pool halves the float
// kernel's bytes; the arithmetic is the same 4*R*D flops a key.  The codes
// come by plain 16-byte loads, D / 16 per lane for K and as many for V,
// all issued before the first is used (lane -> bytes 16*(lane%CK).. of
// keys lane/CK + (32/CK)e with CK = D/16, each key's block looked up in
// the table), and are converted to T in registers on their way to the
// swizzled rows that the
// ldmatrix / ldmatrix.trans path reads: no staging copy of the codes in
// shared memory, and the conversion is exact (|code| <= 127 is exact in
// bf16 and fp16).  K is converted before the products, V after the first
// softmax, so V's loads stay in flight under Q K^T.  The scales are 2-byte
// values (cp.async copies 4 bytes or more), so each lane loads its key's
// two with plain loads and the warp shuffles them to the lanes whose score
// columns hold that key.  They fold in as in the TPU kernel
// (decode_attention.py:169-190): in the exp2 domain s = (q . code_k) *
// (sm_scale * log2e) * ks[j] on the score fragment's column after the
// product, and p * vs[j] becomes the A operand of P V while m and l stay
// over the unscaled p.  At T = 1 and rep = 1 an m16 tile holds one live
// query row: 15 of 16 product rows are padding, which costs nothing that
// shows at this memory-bound shape (per 128-key block the warps issue 64
// mma.sync against 16 KB of codes; the block's time is its loads' latency
// and the merge), so T = 1 takes the same kernel.  f32 queries stay on
// attn_kernel: the tensor cores would round them to tf32.
//
// attn_kernel (f32 pools and caches, f32 queries on int8 pools).  One
// thread block per (row b, KV head g); grid (HKV, B).  The R
// query rows that share the KV head (row r: head g*rep + r/T, window offset
// r%T) sit in shared memory as f32.  The TPU kernel's sequential grid axis
// over KV chunks becomes a loop inside the block over 32-key tiles up to
// the last key any row may see (pos[b] + T - 1, capped at the cache
// length).  Per tile: the threads load K and V with 16-byte vector loads
// into shared memory (f32), threads split the R x 32 scores, one warp per
// query row runs the online-softmax update of the TPU kernel (masking with
// NEG_INF past key pos[b] + r%T), and threads split the R x D accumulator.
// The finish divides by l, with l == 0 read as 1.  It serves f32 only (the
// tensor cores would round f32 to tf32 and miss the fp32 path's
// exactness).  The 16-bit float B3 (T = 1) runs verify_split_kernel, as
// the kv8 B3 runs q8_split_kernel, and so does the 16-bit B2: a contiguous
// cache [B, HKV, S, D] is a pool of B blocks of S keys with the table
// [[0], [1], ...], and generate's decode must share the paged server's
// arithmetic for their greedy tokens to agree.
//
// int8 pools on attn_kernel.  The tile holds the integer codes (as f32)
// and each key's K and V scale; the scales fold into the columns as in the
// TPU kernel: s = (q . code_k) * sm_scale * ks[j], and the probability
// multiplies vs[j] before the P V product, while the online softmax's m
// and l stay over the unscaled probabilities.  No dequantized tile is ever
// written to device memory.
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

// dtype: 0 float32 (of q and out; of the cache or pool too unless Q8, whose
// pool holds int8 codes and bf16 scales); 16-bit q, caches and pools take
// the split-K kernels.  D: 64 (GPT-2) or 128 (llama); another head dim is
// instantiated with the model family that needs it.  Unsupported (dtype, D) pairs
// return cudaErrorInvalidValue; the Python wrappers check them first.
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
    case 128: DS_CASE(TYPE, 128);               \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  DS_DIMS(float);
#undef DS_DIMS
#undef DS_CASE
}


// ------------------------------- paged attention, 16-bit queries, split-K
namespace splitk {

constexpr int KS = 128;          // keys a block (one split)
constexpr int WK = 32;           // keys a warp
constexpr int THREADS = 128;     // 4 warps
constexpr int MAX_R = 256;       // query rows a KV head (rep * T)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r of a [rows][D] 16-bit tile (rows
// of D * 2 bytes, D / 8 chunks) whose chunks are XOR-swizzled by the row in
// their low three bits, so that ldmatrix's 8 row reads hit 8 different
// bank groups (a row of 128 or 256 bytes starts at bank 0).
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// 16 bytes from global to shared memory, asynchronously; bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c[16 x 8] (f32) += a[16 x 16] * b[16 x 8] in T; fragments as mma.sync
// lays them out: c[i] is row lane/4 + 8*(i >> 1), column 2*(lane%4) + (i & 1).
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// 8 f32 values x[i] * inv as 8 T at dst (16-byte aligned).
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* x, float inv) {
  uint4 u;
  u.x = Mma<T>::pack(x[0] * inv, x[1] * inv);
  u.y = Mma<T>::pack(x[2] * inv, x[3] * inv);
  u.z = Mma<T>::pack(x[4] * inv, x[5] * inv);
  u.w = Mma<T>::pack(x[6] * inv, x[7] * inv);
  *reinterpret_cast<uint4*>(dst) = u;
}

// The 16 int8 codes of c as 16 T at dst0 (the first 8) and dst1 (shared
// memory, 16-byte aligned).  Exact: |code| <= 127 is exact in bf16 and fp16.
template <typename T>
__device__ __forceinline__ void store_codes(uint32_t dst0, uint32_t dst1, const int4& c) {
  const uint32_t w[4] = {(uint32_t)c.x, (uint32_t)c.y, (uint32_t)c.z, (uint32_t)c.w};
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t x = w[i >> 1] >> (16 * (i & 1));
    h[i] = Mma<T>::pack((float)(int8_t)(uint8_t)x, (float)(int8_t)(uint8_t)(x >> 8));
  }
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst0), "r"(h[0]), "r"(h[1]),
               "r"(h[2]), "r"(h[3])
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst1), "r"(h[4]), "r"(h[5]),
               "r"(h[6]), "r"(h[7])
               : "memory");
}

// Dynamic shared memory of one block at head dim D: q [MT*16][D], K and V
// [KS][D] in T (2 bytes), the warps' merge tiles [4][16][D + 4] f32 with
// their maxima and sums, and the merge flag.  At D = 128 and R = 64 (a
// 16-token window of llama's GQA rep 4): 16 + 64 + 34 KB.
size_t smem_bytes(int R, int D) {
  const int rows = (R + 15) / 16 * 16;
  return (size_t)rows * D * 2 + 2 * (size_t)KS * D * 2 +
         (4 * 16 * (size_t)(D + 4) + 2 * 4 * 16) * sizeof(float) + 16;
}

// q/out [B, H, T, D] (the (b, g) slice is the contiguous [R, D] run at
// (b*HKV + g) * R * D), D = 64 or 128.  Pools [NB, HKV, bs, D]: in T (KV =
// T), or int8 codes (KV = int8_t) with bf16 scales ksp/vsp [NB, HKV, bs].
// part_o [B*HKV, nsplit, R, D] and part_ml [B*HKV, nsplit, R, 2] f32 hold
// the splits' partials (m in the exp2 domain); tickets [B*HKV] int32 are
// zero between calls.  D sets the rows' width and nothing else: the
// products run D / 16 k-steps of Q K^T and D / 8 n-tiles of P V, and every
// sum over keys, warps and splits is taken in the same order at any D.
template <typename T, typename KV, int D>
__device__ __forceinline__ void split_attention(
    const T* __restrict__ q, const KV* __restrict__ kp, const KV* __restrict__ vp,
    const __nv_bfloat16* __restrict__ ksp, const __nv_bfloat16* __restrict__ vsp,
    const int* __restrict__ bt, const int* __restrict__ pos, T* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int* __restrict__ tickets, int HKV,
    int R, int win, int bs, int nbper, int nsplit, float scale2) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  constexpr int CH = D / 8;                                // 16-byte chunks of a T row
  constexpr int LDO = D + 4;                                // merge tile row stride
  constexpr int CPT = D / 8;                               // merge columns a thread
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z, bg = b * HKV + g;
  const int base = pos[b];
  const int nkeys = max(0, min(base + win, nbper * bs));   // keys 0 .. nkeys-1
  const int nlive = max(1, (nkeys + KS - 1) / KS);
  if (split >= nlive) return;                              // past every row's keys
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int MT = (R + 15) / 16;

  extern __shared__ __align__(128) unsigned char split_smem[];
  unsigned char* smem = split_smem;
  const uint32_t qs = smem_u32(smem);                      // [MT*16][D] T
  const uint32_t ks = qs + MT * 16 * D * 2;                // [KS][D] T
  const uint32_t vs = ks + KS * D * 2;                     // [KS][D] T
  float* mo = reinterpret_cast<float*>(smem + MT * 16 * D * 2 + 2 * KS * D * 2);  // [4][16][LDO]
  float* mm = mo + 4 * 16 * LDO;                           // [4][16] warp maxima
  float* ml = mm + 4 * 16;                                 // [4][16] warp sums
  int* last = reinterpret_cast<int*>(ml + 4 * 16);

  const size_t qoff = (size_t)bg * R * D;
  for (int i = tid; i < MT * 16 * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(qs + swz<D>(r, c), q + qoff + (size_t)min(r, R - 1) * D + c * 8, r < R ? 16 : 0);
  }
  cp_async_commit();
  const int kw = split * KS + warp * WK;
  const bool warp_live = kw < nkeys;
  // int8 pools: a key's D codes are CK 16-byte chunks, KPP keys a pass of
  // the warp's 32 lanes and E passes for its 32 keys
  constexpr int CK = D / 16, KPP = 32 / CK, E = WK / KPP;
  // int8 pools: this lane's V codes until they are converted, and the
  // scales of this lane's score columns
  [[maybe_unused]] int4 vc[E];
  [[maybe_unused]] float kss[4][2], vss[4][2];
  if constexpr (Q8) {
    // this warp's 32 keys: lane -> bytes 16*(lane%CK) .. of keys lane/CK + KPP*e
    int4 kc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int key = kw + lane / CK + KPP * e;
      kc[e] = vc[e] = make_int4(0, 0, 0, 0);
      if (key < nkeys) {
        const int blk = max(bt[(size_t)b * nbper + key / bs], 0);
        const size_t off = (((size_t)blk * HKV + g) * bs + key % bs) * D + (lane % CK) * 16;
        kc[e] = __ldg(reinterpret_cast<const int4*>(kp + off));
        vc[e] = __ldg(reinterpret_cast<const int4*>(vp + off));
      }
    }
    // lane -> the scales of key kw + lane, shuffled to the lanes whose
    // score columns (n*8 + 2*t4 + j) hold it
    float ksl = 0.f, vsl = 0.f;
    if (kw + lane < nkeys) {
      const int key = kw + lane;
      const int blk = max(bt[(size_t)b * nbper + key / bs], 0);
      const size_t soff = ((size_t)blk * HKV + g) * bs + key % bs;
      ksl = __bfloat162float(ksp[soff]);
      vsl = __bfloat162float(vsp[soff]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kss[n][j] = __shfl_sync(0xffffffffu, ksl, n * 8 + 2 * t4 + j);
        vss[n][j] = __shfl_sync(0xffffffffu, vsl, n * 8 + 2 * t4 + j);
      }
    cp_async_wait<0>();
    __syncthreads();                                       // Q, from every thread
    if (warp_live) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = warp * WK + lane / CK + KPP * e;
        store_codes<T>(ks + swz<D>(r, 2 * (lane % CK)), ks + swz<D>(r, 2 * (lane % CK) + 1),
                       kc[e]);
      }
    }
    __syncwarp();                                          // this warp's K
  } else {
    // this warp's 32 keys: lane -> chunk lane%CH of keys lane/CH + KP*e
    constexpr int KP = 32 / CH, EP = WK / KP;
    size_t off[EP];
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      const int key = kw + lane / CH + KP * e;
      off[e] = 0;
      if (key < nkeys) {
        const int blk = max(bt[(size_t)b * nbper + key / bs], 0);
        off[e] = (((size_t)blk * HKV + g) * bs + key % bs) * D + (lane % CH) * 8;
      }
      cp_async16(ks + swz<D>(warp * WK + lane / CH + KP * e, lane % CH), kp + off[e],
                 key < nkeys ? 16 : 0);
    }
    cp_async_commit();
#pragma unroll
    for (int e = 0; e < EP; ++e) {
      const int key = kw + lane / CH + KP * e;
      cp_async16(vs + swz<D>(warp * WK + lane / CH + KP * e, lane % CH), vp + off[e],
                 key < nkeys ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();                                       // Q, from every thread
    cp_async_wait<1>();
    __syncwarp();                                          // this warp's K
    if (!warp_live) cp_async_wait<0>();
  }

  for (int mt = 0; mt < MT; ++mt) {
    float o[D / 8][4];
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
    float m2[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
    if (warp_live) {
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + swz<D>(mt * 16 + (lane & 7) + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + swz<D>(warp * WK + np * 16 + (lane & 7) + (mi >> 1) * 8, 2 * kk + (mi & 1)));
          Mma<T>::run(sc[2 * np], qa, kb[0], kb[1]);
          Mma<T>::run(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // mask per query row, softmax over the warp's 32 keys (exp2 domain);
      // an int8 pool's K scale multiplies its score column
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + n * 8 + 2 * t4 + (e & 1);
          const int r = mt * 16 + g4 + 8 * (e >> 1);
          const bool vis = key < nkeys && r < R && key <= base + r % win;
          float x = sc[n][e] * scale2;
          if constexpr (Q8) x *= kss[n][e & 1];
          x = vis ? x : NEG_INF;
          sc[n][e] = x;
          m2[e >> 1] = fmaxf(m2[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 1));
        m2[h] = fmaxf(m2[h], __shfl_xor_sync(0xffffffffu, m2[h], 2));
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          const float p = x > 0.5f * NEG_INF ? exp2f(x - m2[e >> 1]) : 0.f;
          l2[e >> 1] += p;                                 // l over the unscaled p
          if constexpr (Q8) {
            sc[n][e] = p * vss[n][e & 1];
          } else {
            sc[n][e] = p;
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 1);
        l2[h] += __shfl_xor_sync(0xffffffffu, l2[h], 2);
      }
      // P as the A operand: keys 16j..16j+15 are score tiles 2j and 2j+1
      uint32_t pa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pa[j][0] = Mma<T>::pack(sc[2 * j][0], sc[2 * j][1]);
        pa[j][1] = Mma<T>::pack(sc[2 * j][2], sc[2 * j][3]);
        pa[j][2] = Mma<T>::pack(sc[2 * j + 1][0], sc[2 * j + 1][1]);
        pa[j][3] = Mma<T>::pack(sc[2 * j + 1][2], sc[2 * j + 1][3]);
      }
      if (mt == 0) {
        if constexpr (Q8) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int r = warp * WK + lane / CK + KPP * e;
            store_codes<T>(vs + swz<D>(r, 2 * (lane % CK)), vs + swz<D>(r, 2 * (lane % CK) + 1),
                           vc[e]);
          }
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();                                      // this warp's V
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vs + swz<D>(warp * WK + 16 * j + (lane & 7) + (mi & 1) * 8, 2 * dp + (mi >> 1)));
          Mma<T>::run(o[2 * dp], pa[j], vb[0], vb[1]);
          Mma<T>::run(o[2 * dp + 1], pa[j], vb[2], vb[3]);
        }
    }
    // the block's partial for rows mt*16 ..: merge the four warps
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(&mo[(warp * 16 + g4 + 8 * h) * LDO + d * 8 + 2 * t4]) =
            make_float2(o[d][2 * h], o[d][2 * h + 1]);
    if (t4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mm[warp * 16 + g4 + 8 * h] = m2[h];
        ml[warp * 16 + g4 + 8 * h] = l2[h];
      }
    }
    __syncthreads();
    {
      // thread -> row tid / 8 of the tile, columns c0 .. c0 + CPT - 1
      const int row = tid >> 3, c0 = (tid & 7) * CPT, grow = mt * 16 + row;
      float mstar = NEG_INF;
#pragma unroll
      for (int w = 0; w < 4; ++w) mstar = fmaxf(mstar, mm[w * 16 + row]);
      float lsum = 0.f, acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float wt = exp2f(mm[w * 16 + row] - mstar);
        lsum += wt * ml[w * 16 + row];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] += wt * mo[(w * 16 + row) * LDO + c0 + c];
      }
      if (grow < R) {
        if (nlive == 1) {
          const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
#pragma unroll
          for (int c = 0; c < CPT; c += 8)
            store8(out + qoff + (size_t)grow * D + c0 + c, acc + c, inv);
        } else {
          const size_t pr = ((size_t)bg * nsplit + split) * R + grow;
          float4* po = reinterpret_cast<float4*>(part_o + pr * D + c0);
#pragma unroll
          for (int c = 0; c < CPT / 4; ++c)
            po[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
          if ((tid & 7) == 0) *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(mstar, lsum);
        }
      }
    }
    __syncthreads();
  }
  if (nlive == 1) return;

  // the last block of (b, g) to finish merges the splits, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[bg], 1);
    *last = ticket == nlive - 1;
    if (*last) tickets[bg] = 0;                            // clean for the next call
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* po = part_o + (size_t)bg * nsplit * R * D;
  const float* pml = part_ml + (size_t)bg * nsplit * R * 2;
  for (int i = tid; i < R * CH; i += THREADS) {
    const int row = i / CH, c0 = (i % CH) * 8;
    float mstar = NEG_INF;
    for (int sp = 0; sp < nlive; ++sp) mstar = fmaxf(mstar, __ldcg(pml + ((size_t)sp * R + row) * 2));
    float lsum = 0.f, acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int sp = 0; sp < nlive; ++sp) {
      const size_t pr = (size_t)sp * R + row;
      const float2 ml_s = __ldcg(reinterpret_cast<const float2*>(pml + pr * 2));
      const float wt = exp2f(ml_s.x - mstar);
      lsum += wt * ml_s.y;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(po + pr * D + c0));
      const float4 c = __ldcg(reinterpret_cast<const float4*>(po + pr * D + c0 + 4));
      acc[0] += wt * a.x; acc[1] += wt * a.y; acc[2] += wt * a.z; acc[3] += wt * a.w;
      acc[4] += wt * c.x; acc[5] += wt * c.y; acc[6] += wt * c.z; acc[7] += wt * c.w;
    }
    store8(out + qoff + (size_t)row * D + c0, acc, 1.f / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
verify_split_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ bt, const int* __restrict__ pos, T* __restrict__ out,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int* __restrict__ tickets, int HKV, int R, int win, int bs, int nbper,
                    int nsplit, float scale2) {
  split_attention<T, T, D>(q, kp, vp, nullptr, nullptr, bt, pos, out, part_o, part_ml, tickets,
                           HKV, R, win, bs, nbper, nsplit, scale2);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
q8_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                const __nv_bfloat16* __restrict__ ksc, const int8_t* __restrict__ vc,
                const __nv_bfloat16* __restrict__ vsc, const int* __restrict__ bt,
                const int* __restrict__ pos, T* __restrict__ out, float* __restrict__ part_o,
                float* __restrict__ part_ml, int* __restrict__ tickets, int HKV, int R, int win,
                int bs, int nbper, int nsplit, float scale2) {
  split_attention<T, int8_t, D>(q, kc, vc, ksc, vsc, bt, pos, out, part_o, part_ml, tickets, HKV,
                                R, win, bs, nbper, nsplit, scale2);
}

// KV = T: a 16-bit pool (k, v; the scales unused); KV = int8_t: codes k, v
// with bf16 scales k_scale, v_scale.
template <typename T, typename KV, int D>
int launch(const void* q, const void* k, const void* k_scale, const void* v,
           const void* v_scale, const void* bt, const void* pos, void* out, void* scratch,
           void* tickets, int B, int H, int HKV, int win, int bs, int nbper, int nsplit,
           float scale, void* stream) {
  const int R = (H / HKV) * win;
  if (R > MAX_R || nsplit != (nbper * bs + KS - 1) / KS) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(R, D);
  float* part_o = (float*)scratch;
  float* part_ml = part_o + (size_t)B * HKV * nsplit * R * D;
  const dim3 grid(nsplit, HKV, B);
  cudaError_t e;
  if constexpr (std::is_same<KV, int8_t>::value) {
    e = cudaFuncSetAttribute(q8_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    q8_split_kernel<T, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const int8_t*)k, (const __nv_bfloat16*)k_scale, (const int8_t*)v,
        (const __nv_bfloat16*)v_scale, (const int*)bt, (const int*)pos, (T*)out, part_o, part_ml,
        (int*)tickets, HKV, R, win, bs, nbper, nsplit, scale * LOG2E);
  } else {
    e = cudaFuncSetAttribute(verify_split_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    verify_split_kernel<T, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)bt, (const int*)pos, (T*)out, part_o,
        part_ml, (int*)tickets, HKV, R, win, bs, nbper, nsplit, scale * LOG2E);
  }
  return (int)cudaGetLastError();
}

// dtype 1 (fp16) or 2 (bf16) of q and out, D 64 or 128: launch<T, KV, D>
// with KV = T, or int8_t when Q8.
template <bool Q8, int D>
int dispatch_d(int dtype, const void* q, const void* k, const void* k_scale, const void* v,
               const void* v_scale, const void* bt, const void* pos, void* out, void* scratch,
               void* tickets, int B, int H, int HKV, int T, int bs, int nbper, int nsplit,
               float scale, void* stream) {
  switch (dtype) {
    case 1:
      return launch<__half, typename std::conditional<Q8, int8_t, __half>::type, D>(
          q, k, k_scale, v, v_scale, bt, pos, out, scratch, tickets, B, H, HKV, T, bs, nbper,
          nsplit, scale, stream);
    case 2:
      return launch<__nv_bfloat16, typename std::conditional<Q8, int8_t, __nv_bfloat16>::type,
                    D>(q, k, k_scale, v, v_scale, bt, pos, out, scratch, tickets, B, H, HKV, T,
                       bs, nbper, nsplit, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool Q8>
int dispatch(int dtype, const void* q, const void* k, const void* k_scale, const void* v,
             const void* v_scale, const void* bt, const void* pos, void* out, void* scratch,
             void* tickets, int B, int H, int HKV, int T, int bs, int nbper, int nsplit,
             int D, float scale, void* stream) {
  switch (D) {
    case 64:
      return dispatch_d<Q8, 64>(dtype, q, k, k_scale, v, v_scale, bt, pos, out, scratch, tickets,
                                B, H, HKV, T, bs, nbper, nsplit, scale, stream);
    case 128:
      return dispatch_d<Q8, 128>(dtype, q, k, k_scale, v, v_scale, bt, pos, out, scratch,
                                 tickets, B, H, HKV, T, bs, nbper, nsplit, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace splitk

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

// bf16 (dtype 2) or fp16 (1) q, pools and out; D = 64 or 128.  scratch:
// f32 [B*HKV*nsplit*R*(D+2)] for the splits' partials, R = (H/HKV)*T; tickets:
// int32 [B*HKV], zero on entry and on return; nsplit = ceil(nbper*bs/128).
int ds_paged_verify_attention_split(const void* q, const void* k_pool,
                                    const void* v_pool, const void* block_tables,
                                    const void* pos, void* out, void* scratch,
                                    void* tickets, int B, int H, int HKV, int T,
                                    int bs, int nbper, int nsplit, int D,
                                    int dtype, float scale, void* stream) {
  return splitk::dispatch<false>(dtype, q, k_pool, nullptr, v_pool, nullptr, block_tables, pos,
                                 out, scratch, tickets, B, H, HKV, T, bs, nbper, nsplit, D,
                                 scale, stream);
}

// bf16 (dtype 2) or fp16 (1) q and out, T <= 16 (1 for decode), against an
// int8 pool: codes int8 [NB,HKV,bs,D] and scales bf16 [NB,HKV,bs] for K and
// for V; D = 64 or 128; scratch, tickets and nsplit as for
// ds_paged_verify_attention_split.
int ds_paged_attention_q8_split(const void* q, const void* k_codes, const void* k_scale,
                                const void* v_codes, const void* v_scale,
                                const void* block_tables, const void* pos, void* out,
                                void* scratch, void* tickets, int B, int H, int HKV, int T,
                                int bs, int nbper, int nsplit, int D, int dtype, float scale,
                                void* stream) {
  return splitk::dispatch<true>(dtype, q, k_codes, k_scale, v_codes, v_scale, block_tables, pos,
                                out, scratch, tickets, B, H, HKV, T, bs, nbper, nsplit, D, scale,
                                stream);
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
