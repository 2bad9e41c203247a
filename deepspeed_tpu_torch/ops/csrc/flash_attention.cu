// Flash attention, forward and backward, for Hopper (sm_90a): causal or
// full attention of q [BH, Sq, D] against k/v [BH/rep, Sk, D] (GQA: query
// head bh reads KV head bh / rep in place), with an f32 online softmax and
// the recomputing backward driven by the row log-sum-exp.
//
// Entry points and the TPU kernels they replace
// (deepspeed_tpu/ops/flash_attention.py):
//   ds_flash_attention_fwd     <- _fwd (v1, :142), _fwd_v2 (:526) and
//                                 _fwd_v3 (:736): o and the natural-log lse
//                                 [BH, Sq] f32 (v1's format; v2 returns no
//                                 lse and v3 an exp2-domain one)
//   ds_flash_attention_bwd_dq  <- _bwd_dq_call (v1, :317), the dq half of
//                                 _bwd_v2 (:617) and _bwd_v3 (:881): dq given
//                                 lse and delta = rowsum(dO * O); with o
//                                 given it computes delta itself and writes
//                                 it out for the dkv kernel
//   ds_flash_attention_bwd_dkv <- _bwd_dkv_call (v1, :365), the dk/dv half
//                                 of _bwd_v2 and _bwd_v3 (:901): dk, dv
//                                 summed over the rep query heads of a KV
//                                 head
//   ds_flash_attention_{fwd,bwd_dq,bwd_dkv}_layout
//                              <- the same three with v1's block-sparse
//                                 layout gate (_fwd_kernel :63-68,
//                                 _bwd_dq_kernel :183-188, _bwd_dkv_kernel
//                                 :244-249; _sparse_attention_bh :982):
//                                 the same kernels instantiated GATED
// Every one returns cudaGetLastError() after its launch.
//
// The TPU kernels walk a sequential grid axis and carry m/l/acc in VMEM
// scratch from one grid step to the next; here one thread block owns an
// output tile and loops over the other axis itself, up to the last key any
// of its rows may see (the diagonal under causal, as the TPU kernels'
// pl.when skip).  Scores, probabilities and accumulators are f32; P and dS
// are rounded to the input type before their products, as the TPU kernels
// do.  The softmax runs in the exp2 domain with sm_scale * log2(e) applied
// to the f32 scores.  Masked: keys >= Sk, keys above the diagonal (key >
// query row, top-left aligned, as tril(ones(Sq, Sk))) and query rows >= Sq.
//
// Forward, bf16 (wgmma_fwd_kernel).  Bound: at the GPT-2 train shape (B=8,
// H=12, S=1024, D=64, causal) it does 2*B*H*S^2*D = 12.9 GFLOP on 51 MB of
// q, k, v, o and lse: about 13 us of bf16 tensor-core work against 15 us of
// HBM traffic, so it is bound by both at once, and only the card's full
// tensor-core rate (wgmma) with loads kept in flight (TMA) gets near it.
// One block per (128-row query tile, bh), the heaviest causal tiles
// launched first; two consumer warpgroups own 64 query rows each and one
// producer warp keeps a 3-stage ring of 128-key K and V tiles in flight
// with TMA (3-D tensor maps (D, S, BH), so a head's ragged last tile
// zero-fills instead of reading the next head; 128-byte swizzle), full and
// empty mbarriers per stage in place of __syncthreads.  S = Q K^T is
// wgmma.m64n128k16 from shared memory (Q and K K-major) into registers; the
// online softmax runs on the accumulator's fragments (row max and sum over
// the quad of threads sharing a row, ex2 on one FMA of score and max); P is
// converted to bf16 in registers and is the register A operand of
// wgmma.m64n64k16 against V read MN-major, so neither S nor P nor O ever
// touches shared memory.  The products overlap the softmax: S_{t+1} is
// issued before P_t V_t, and the softmax of tile t runs while P_{t-1}
// V_{t-1} is still on the tensor cores.  The tensor maps are encoded per
// call with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
// (no link against libcuda), and passed as __grid_constant__ parameters,
// so a CUDA graph captures them by value.
//
// Backward, bf16 (wgmma_dq_kernel, wgmma_dkv_kernel).  Bound: at the train
// shape dq does 6 and dkv 8 flops per visible (query, key) pair and dim,
// 19.4 and 25.8 GFLOP, and each moves 76 MB: 20 and 26 us of tensor-core
// work against 23 us of HBM traffic, so both sit at both limits, and what
// keeps them from the bound is how the products are fed: operands from
// shared memory that TMA filled ahead of use, results kept in registers.  The same machinery as the forward, with no online softmax:
// P = exp2(S scale2 - lse2) and dS = P (dP - delta) are computed on the
// accumulator fragments of the two score products, rounded to bf16 in
// registers, and are the register A operand of the gradient products.
//   dq: one block per (128-row query tile, bh), the heaviest causal tiles
//   first; two consumer warpgroups own 64 rows each, Q and dO are loaded
//   once, and one producer warp streams 64-key K and V tiles through a
//   3-stage ring.  S = Q K^T and dP = dO V^T are wgmma.m64n64k16 from
//   shared memory (K and V K-major), dQ += dS K is wgmma.m64n64k16 with dS
//   from registers and the same K tile read MN-major.  With 64-key tiles S,
//   dP, the packed dS and the dQ accumulator are 112 values a thread, within
//   the 168 registers that 288 threads get (128-key tiles would need 192
//   with the next tile's products in flight).  With o given,
//   delta = rowsum(dO O) is computed in a prologue, each row by the quad of
//   threads that holds it, and written out for the dkv call.
//   dkv: the transposed problem, so that every operand lies where wgmma
//   wants it: one block per (128-key tile, KV head), the key tiles that see
//   the most queries first; two consumer warpgroups own 64 keys each, K and
//   V are loaded once, and a producer warp streams 64-row Q and dO tiles
//   of each of the rep query heads (from the diagonal on, under causal),
//   with their lse and delta, which a tensor map cannot carry (a [BH, Sq]
//   f32 row is not 16-byte aligned for every Sq), loaded by its lanes into
//   the stage.  S^T = K Q^T and dP^T = V dO^T are wgmma.m64n64k16 from
//   shared memory; P^T and dS^T take lse and delta by their fragment's
//   column; dV += P^T dO and dK += dS^T Q read dO and Q MN-major.  The
//   consumers need 232 registers a thread, which the producer warpgroup
//   hands them with setmaxnreg.  dk and dv stay in registers over all query
//   tiles and are written once, so the gradients come out the same from
//   run to run (no atomics).
//
// The layout gate (GATED instantiations).  The TPU kernels run one grid
// program per (query block, key block) of the layout and skip it where
// the layout is 0.  Here a block walks a list of live tiles instead: the
// tile map that ops/flash_attention.py::layout_tile_map builds once per
// layout, one row per (query head, query tile) listing key tiles in key
// order (forward, dq), or per (KV head, key tile) listing the (rep head g,
// query tile) pairs in g-major order (dkv), so a tile with no visible pair
// costs neither a load nor a product.  The wgmma kernels launch their
// blocks in the map's order, the longest lists first (a global row of
// BigBird or Longformer sees every key tile).  A layout block may be
// smaller than a tile (16 against 128), so each live tile carries the
// bits of its layout sub-blocks: the producer writes them with the tile's
// flags into the stage beside its tiles, and the consumers mask a tile
// that is not FULL in a pass of its own (gate_pass) before the softmax;
// dkv's producer instead writes each query row's lse once per key
// sub-block, +inf where the layout gates the pair off.  A query row that
// sees no key gets o = 0 and lse = -inf, and dq = 0; masked entries are
// selected to -inf before exp2, never multiplied by a zero mask, since
// such a row's exp2(S - lse) is +inf.  A query tile with no live key tile
// writes its zeros and returns before any barrier is used, and the
// consumers' first waits trap after 10 s, so a list no producer walks
// fails the launch instead of hanging the card.  The gated kernels do the
// work of the live tiles, not of the visible pairs: at block 16 every
// 128 x 128 tile of DeepSpeed's Fixed layout is live.
//
// Head dim 128 (Llama; ungated only).  Bound: at Llama-3-8B's training
// shape (B=1, H=32, Hkv=8, S=8192, causal) the forward does 550 GFLOP,
// dq 825 and dkv 1100 on 169-304 MB: 0.56, 0.83 and 1.11 ms of bf16
// tensor-core work against 0.05-0.09 ms of HBM traffic, so all three are
// bound by the products.  The same kernels instantiated at D = 128
// (Head<128>): each Q/K/V/dO tile is two 64-column spans, each a TMA box
// of its own and a 128-byte-swizzled [rows][64] tile (a 256-byte row does
// not fit one 128-byte swizzle atom), the k-loop of a score product 8
// k-steps of 16 over the two spans, and each product whose N is D one
// m64n64 wgmma a span.  Registers: O (dQ) is 64 a consumer thread and S
// 64 (dq: S, dP 32 each), so the forward and dq take a producer
// warpgroup and setmaxnreg 24 / 240; dkv keeps 40 / 232 and runs each
// tile's two product pairs in turn (its dK and dV are 128 registers).
// Shared memory: the forward's ring is 2 stages of 32 KB K and V tiles
// (161 KB with Q), dq's 3 stages of 16 KB K and V (161 KB with Q and dO),
// dkv's 3 stages of 16 KB Q and dO (163 KB with K and V).
//
// fp16 (the JAX engine's fp16.enabled runs the same Pallas kernels in
// float16).  The three wgmma kernels take their element type E as a
// template parameter (Elt): fp16 is wgmma .f32.f16.f16, TMA maps of
// CU_TENSOR_MAP_DATA_TYPE_FLOAT16 and __floats2half2_rn packs, at D = 64
// and 128, with the bf16 tiles, rings and registers unchanged (2 bytes an
// element either way).  The rounding points are the TPU kernels': the
// scores are f32 products scaled in f32 (v1's `s * sm_scale`), P is
// rounded to E before P V, dS to E before dS K and dS^T Q, lse and delta
// stay f32.  fp16 tops out at 65504: under a loss scale of 2^16 dP and dS
// can pass it, and then the pack gives inf exactly where the TPU kernel's
// astype does, so the engine's overflow check skips the step; nothing is
// clamped and dS is never kept in f32 past that point.  Bound: the bf16
// rows' bytes and operations (989 TFLOP/s dense fp16 = bf16).
//
// Forward and backward, f32 (fwd_kernel, dq_kernel, dkv_kernel): 64x64
// tiles in shared memory and a plain f32 loop for the products (the tensor
// cores would round f32 to tf32 and miss fp32's 1e-5); at D = 128 only K
// and V keep padded rows (F32Tiles), so dkv's eight tiles fit a block.
// dkv: one block per (key tile of 64, KV head) over the query tiles of all
// rep query heads from the diagonal on; dk/dv are written once at the end.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int NTHREADS = 128;    // 4 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // DEFAULT_MASK_VALUE
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int LDF = 68;          // row stride of the f32 [64][64] tiles at D = 64

// Row strides (floats) of the f32 kernels' shared tiles.  K and V, which
// the score products read across threads by row (B^T), are padded by 4 so
// that rows start on distinct banks; at D = 64 every tile keeps that
// stride (68, a multiple of 16 bytes).  At D = 128 the other tiles (Q, dO,
// the [64][D] sums and the [64][64] score tiles) are read along their rows
// only and stay unpadded, so that dkv's eight tiles fit the 232,448 bytes
// a block may use (231,936).
template <int D>
struct F32Tiles {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int KV = D + 4;                 // K, V
  static constexpr int ROW = D == 64 ? LDF : D;    // Q, dO, o / dq / dk / dv sums
  static constexpr int SC = D == 64 ? LDF : 64;    // S, dP, P, dS [64][64]
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// Rows row0 .. row0+63 of a row-major [rows, D] array into a [64][ld] tile,
// with 16-byte loads; rows past `valid` are zero.
template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, int row0, int valid) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int DV = D / VN;
  for (int i = threadIdx.x; i < 64 * DV; i += NTHREADS) {
    const int r = i / DV, c = (i % DV) * VN;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// C[M x N] (f32, row stride ldc) = (ACC ? C : 0) + A[M x K] * B[K x N] in
// plain f32, the threads splitting C's entries.  A is row-major
// (A[m*lda + k]) or, with A_T, the transpose of a row-major [K x M] tile
// (A[k*lda + m]); B is row-major [K x N] (B[k*ldb + n]) or, with B_T, the
// transpose of a row-major [N x K] tile (B[n*ldb + k]).
template <bool A_T, bool B_T, bool ACC>
__device__ void mma_tile(const float* A, int lda, const float* B, int ldb,
                         float* C, int ldc, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += NTHREADS) {
    const int m = i / N, n = i % N;
    float acc = ACC ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k)
      acc += (A_T ? A[k * lda + m] : A[m * lda + k]) * (B_T ? B[n * ldb + k] : B[k * ldb + n]);
    C[m * ldc + n] = acc;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row);
}

// ------------------------------------------------------------ layout gate
// A gated kernel's tile map (ops/flash_attention.py::TileMap): the live
// tiles of map row r are entries[offsets[r] .. offsets[r + 1]), each a
// tile index (dkv: g * query tiles + query tile) with FULL set when every
// element of the tile is visible and DIAG when, under causal, some key of
// the tile lies after some query of it, and masks[] the tile's layout
// sub-blocks: bit 8 * (query >> shift - first query >> shift) +
// (key >> shift - first key >> shift), counted from the tile's first
// query and key.  A layout block never straddles S (S % block == 0), so
// the bits also mask the keys >= S.
struct Gate {
  const int* offsets;                 // [rows + 1]
  const int* entries;                 // tile index | FULL
  const unsigned long long* masks;    // sub-block bits of each entry
  const int* order;                   // map rows, the longest lists first
  int heads;                          // query heads (forward, dq), KV heads (dkv)
  int shift;                          // log2 of the layout's block
};
constexpr int FULL = 1 << 30;
constexpr int DIAG = 1 << 29;

// A wgmma kernel's stage descriptor, which its producer writes beside the
// stage's tiles before the stage's barrier completes: the tile's index,
// flags and sub-block bits, so the consumers read them from shared memory
// and never wait on the map in device memory.
struct StageTile {
  int index;
  int flags;
  unsigned long long bits;
};

struct Tile {
  int index;                          // as in Gate::entries, without the flags
  int flags;                          // FULL (no entry masked) | DIAG
  unsigned long long bits;            // layout sub-blocks
};

// Entry t of the list from `first`; ungated, tile t itself.
template <bool GATED>
__device__ __forceinline__ Tile tile_at(const Gate& g, int first, int t) {
  if constexpr (GATED) {
    const int e = __ldg(g.entries + first + t);
    return {e & (DIAG - 1), e & (FULL | DIAG), __ldg(g.masks + first + t)};
  } else {
    return {t, 0, 0ull};
  }
}

// The bit of local query sub-block qbit / 8 and key sub-block kblk.
__device__ __forceinline__ bool sub_on(unsigned long long bits, int qbit, int kblk) {
  return (bits >> (qbit + kblk)) & 1ull;
}

// Entries [first, first + count) of map row `row`.
__device__ __forceinline__ int gate_row(const Gate& g, int row, int& first) {
  first = __ldg(g.offsets + row);
  return __ldg(g.offsets + row + 1) - first;
}

// -inf: a score the mask removed, and the row maximum before any key
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// kbits (a row of a tile's sub-block bits, one bit a block of 1 << shift
// keys, shift >= 4) spread to one bit per 8 keys, for a tile of 8 * pairs
// keys: the key columns a wgmma fragment thread holds come in runs of 8
// (8 j + 2 (lane % 4) + {0, 1}), each inside one block.  Built once a tile
// by a loop the compiler keeps rolled, so the element tests are a shift
// by a constant.
__device__ __forceinline__ uint32_t pair_bits(uint32_t kbits, int shift, int pairs) {
  const int per = min(pairs, 1 << (shift - 3));           // 8-key runs a block
  const uint32_t run = per == 32 ? 0xffffffffu : (1u << per) - 1u;
  uint32_t pm = 0;
#pragma unroll 1
  for (int b = 0; b * per < pairs; ++b)
    if ((kbits >> b) & 1u) pm |= run << (b * per);
  return pm;
}

// ------------------------------------------------------- f32 tile kernels
// (bf16 and fp16 take the wgmma kernels below)
template <typename T, int D>
constexpr size_t fwd_smem() {
  using L = F32Tiles<D>;
  return 64 * (2 * L::ROW + 2 * L::KV + 2 * L::SC) * sizeof(float) + 3 * 64 * sizeof(float);
}

template <typename T, int D, bool GATED>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int rep,
           int causal, float scale2, const Gate gate) {
  static_assert(std::is_same<T, float>::value, "the bf16 forward is wgmma_fwd_kernel");
  using L = F32Tiles<D>;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, kvh = bh / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);             // [BQ][ROW]
  T* ks = qs + 64 * L::ROW;                       // [BK][KV]
  T* vs = ks + 64 * L::KV;                        // [BK][KV]
  T* ps = vs + 64 * L::KV;                        // [BQ][SC] probabilities
  float* ss = reinterpret_cast<float*>(ps + 64 * L::SC);  // [BQ][SC] scores
  float* os = ss + 64 * L::SC;                    // [BQ][ROW] output sums
  float* m = os + 64 * L::ROW;                    // [BQ] running max (log2)
  float* l = m + BQ;                              // [BQ] running sum
  float* alpha = l + BQ;                          // [BQ] this tile's rescale

  const T* kb = k + (size_t)kvh * Sk * D;
  const T* vb = v + (size_t)kvh * Sk * D;
  load_tile<T, D>(qs, L::ROW, q + (size_t)bh * Sq * D, q0, min(BQ, Sq - q0));
  for (int i = tid; i < BQ * D; i += NTHREADS) os[(i / D) * L::ROW + i % D] = 0.f;
  for (int r = tid; r < BQ; r += NTHREADS) { m[r] = NEG_INF; l[r] = 0.f; }
  const int k_end = causal ? min(Sk, min(q0 + BQ, Sq)) : Sk;
  __syncthreads();

  // the key tile at k0 (GATED: with its sub-block bits)
  auto step = [&](int k0, Tile tl) {
    load_tile<T, D>(ks, L::KV, kb, k0, min(BK, Sk - k0));
    load_tile<T, D>(vs, L::KV, vb, k0, min(BK, Sk - k0));
    __syncthreads();
    mma_tile<false, true, false>(qs, L::ROW, ks, L::KV, ss, L::SC, BQ, BK, D);
    __syncthreads();
    for (int r = warp; r < BQ; r += NWARPS) {
      const int row = q0 + r;
      float s[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int j = lane + 32 * e;
        bool vis = visible(row, k0 + j, Sq, Sk, causal);
        if constexpr (GATED)
          vis = vis && sub_on(tl.bits, 8 * ((row >> gate.shift) - (q0 >> gate.shift)),
                              ((k0 + j) >> gate.shift) - (k0 >> gate.shift));
        s[e] = vis ? ss[r * L::SC + j] * scale2 : NEG_INF;
        mx = fmaxf(mx, s[e]);
      }
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const float p = s[e] > 0.5f * NEG_INF ? exp2f(s[e] - m_new) : 0.f;
        ps[r * L::SC + lane + 32 * e] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = exp2f(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += NTHREADS) os[(i / D) * L::ROW + i % D] *= alpha[i / D];
    __syncthreads();
    mma_tile<false, false, true>(ps, L::SC, vs, L::KV, os, L::ROW, BQ, D, BK);
    __syncthreads();
  };
  if constexpr (GATED) {
    int first;
    const int ntiles = gate_row(gate, (bh % gate.heads) * gridDim.x + blockIdx.x, first);
    for (int t = 0; t < ntiles; ++t) {
      const Tile tl = tile_at<true>(gate, first, t);
      step(tl.index * BK, tl);
    }
  } else {
    for (int k0 = 0; k0 < k_end; k0 += BK) step(k0, Tile{0, 0, 0ull});
  }

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D;
    if (q0 + r < Sq) {
      const float lr = l[r] == 0.f ? 1.f : l[r];
      o[((size_t)bh * Sq + q0 + r) * D + i % D] = from_f<T>(os[r * L::ROW + i % D] / lr);
    }
  }
  for (int r = tid; r < BQ; r += NTHREADS)
    if (q0 + r < Sq) {
      float x = m[r] * LN2 + logf(l[r] == 0.f ? 1.f : l[r]);
      if constexpr (GATED) x = l[r] == 0.f ? neg_inf() : x;   // a row that sees no key
      lse[(size_t)bh * Sq + q0 + r] = x;
    }
}

// ----------------------------------------------------------------------- dq
template <typename T, int D>
constexpr size_t dq_smem() {
  using L = F32Tiles<D>;
  return 64 * (3 * L::ROW + 2 * L::KV + 3 * L::SC) * sizeof(float) + 2 * 64 * sizeof(float);
}

template <typename T, int D, bool GATED>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
          int Sq, int Sk, int rep, int causal, float sm_scale, const Gate gate) {
  static_assert(std::is_same<T, float>::value, "the bf16 dq is wgmma_dq_kernel");
  using L = F32Tiles<D>;
  const float scale2 = sm_scale * LOG2E;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, kvh = bh / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);             // [BQ][ROW]
  T* dos = qs + 64 * L::ROW;                      // [BQ][ROW]
  T* ks = dos + 64 * L::ROW;                      // [BK][KV]
  T* vs = ks + 64 * L::KV;                        // [BK][KV]
  T* dss = vs + 64 * L::KV;                       // [BQ][SC] dS
  float* ss = reinterpret_cast<float*>(dss + 64 * L::SC);  // [BQ][SC] scores
  float* dps = ss + 64 * L::SC;                   // [BQ][SC] dO V^T
  float* dqs = dps + 64 * L::SC;                  // [BQ][ROW] dq sums
  float* lse2 = dqs + 64 * L::ROW;                // [BQ] lse * log2(e)
  float* dl = lse2 + BQ;                          // [BQ] delta

  const size_t qoff = (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvh * Sk * D;
  const T* vb = v + (size_t)kvh * Sk * D;
  load_tile<T, D>(qs, L::ROW, q + qoff, q0, min(BQ, Sq - q0));
  load_tile<T, D>(dos, L::ROW, dout + qoff, q0, min(BQ, Sq - q0));
  for (int i = tid; i < BQ * D; i += NTHREADS) dqs[(i / D) * L::ROW + i % D] = 0.f;
  for (int r = warp; r < BQ; r += NWARPS) {
    const int row = q0 + r;
    float dr = 0.f;
    if (row < Sq && o != nullptr) {       // delta = rowsum(dO * O), f32
      const size_t off = qoff + (size_t)row * D;
      for (int c = lane; c < D; c += 32) dr += to_f(dout[off + c]) * to_f(o[off + c]);
      dr = warp_sum(dr);
      if (lane == 0) delta[(size_t)bh * Sq + row] = dr;
    } else if (row < Sq) {
      dr = delta[(size_t)bh * Sq + row];
    }
    if (lane == 0) {
      dl[r] = dr;
      lse2[r] = row < Sq ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
    }
  }
  const int k_end = causal ? min(Sk, min(q0 + BQ, Sq)) : Sk;
  __syncthreads();

  // the key tile at k0 (GATED: with its sub-block bits)
  auto step = [&](int k0, Tile tl) {
    load_tile<T, D>(ks, L::KV, kb, k0, min(BK, Sk - k0));
    load_tile<T, D>(vs, L::KV, vb, k0, min(BK, Sk - k0));
    __syncthreads();
    mma_tile<false, true, false>(qs, L::ROW, ks, L::KV, ss, L::SC, BQ, BK, D);
    mma_tile<false, true, false>(dos, L::ROW, vs, L::KV, dps, L::SC, BQ, BK, D);
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NTHREADS) {
      const int r = i / BK, j = i % BK;
      float ds = 0.f;
      bool vis = visible(q0 + r, k0 + j, Sq, Sk, causal);
      if constexpr (GATED)
        vis = vis && sub_on(tl.bits, 8 * (((q0 + r) >> gate.shift) - (q0 >> gate.shift)),
                            ((k0 + j) >> gate.shift) - (k0 >> gate.shift));
      if (vis) {
        const float p = exp2f(ss[r * L::SC + j] * scale2 - lse2[r]);
        ds = p * (dps[r * L::SC + j] - dl[r]);
      }
      dss[r * L::SC + j] = from_f<T>(ds);
    }
    __syncthreads();
    mma_tile<false, false, true>(dss, L::SC, ks, L::KV, dqs, L::ROW, BQ, D, BK);
    __syncthreads();
  };
  if constexpr (GATED) {
    int first;
    const int ntiles = gate_row(gate, (bh % gate.heads) * gridDim.x + blockIdx.x, first);
    for (int t = 0; t < ntiles; ++t) {
      const Tile tl = tile_at<true>(gate, first, t);
      step(tl.index * BK, tl);
    }
  } else {
    for (int k0 = 0; k0 < k_end; k0 += BK) step(k0, Tile{0, 0, 0ull});
  }

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D;
    if (q0 + r < Sq)
      dq[qoff + (size_t)(q0 + r) * D + i % D] = from_f<T>(dqs[r * L::ROW + i % D] * sm_scale);
  }
}

// ---------------------------------------------------------------------- dkv
// P and dS are written over the f32 tiles they come from.
template <typename T, int D>
constexpr size_t dkv_smem() {
  using L = F32Tiles<D>;
  return 64 * (4 * L::ROW + 2 * L::KV + 2 * L::SC) * sizeof(float) + 2 * 64 * sizeof(float);
}

template <typename T, int D, bool GATED>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int Sq, int Sk, int rep, int causal, float sm_scale, const Gate gate) {
  static_assert(std::is_same<T, float>::value, "the bf16 dkv is wgmma_dkv_kernel");
  using L = F32Tiles<D>;
  const float scale2 = sm_scale * LOG2E;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y;
  const int tid = threadIdx.x;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PER = BQ * BK / NTHREADS;         // score entries per thread
  T* ks = reinterpret_cast<T*>(smem);             // [BK][KV]
  T* vs = ks + 64 * L::KV;                        // [BK][KV]
  T* qs = vs + 64 * L::KV;                        // [BQ][ROW]
  T* dos = qs + 64 * L::ROW;                      // [BQ][ROW]
  float* ss = reinterpret_cast<float*>(dos + 64 * L::ROW);  // [BQ][SC] scores
  float* dps = ss + 64 * L::SC;                   // [BQ][SC] dO V^T
  float* dks = dps + 64 * L::SC;                  // [BK][ROW] dk sums
  float* dvs = dks + 64 * L::ROW;                 // [BK][ROW] dv sums
  float* lse2 = dvs + 64 * L::ROW;                // [BQ]
  float* dl = lse2 + BQ;                          // [BQ]
  T* pts = reinterpret_cast<T*>(ss);              // [BQ][SC] P, over ss
  T* dss = reinterpret_cast<T*>(dps);             // [BQ][SC] dS, over dps

  const size_t koff = (size_t)kvh * Sk * D;
  load_tile<T, D>(ks, L::KV, k + koff, k0, min(BK, Sk - k0));
  load_tile<T, D>(vs, L::KV, v + koff, k0, min(BK, Sk - k0));
  for (int i = tid; i < BK * D; i += NTHREADS) {
    dks[(i / D) * L::ROW + i % D] = 0.f;
    dvs[(i / D) * L::ROW + i % D] = 0.f;
  }
  // query rows above the diagonal never see these keys
  const int q_start = causal ? (k0 / BQ) * BQ : 0;

  // one query tile of query head bh: dk += dS^T Q, dv += P^T dO
  auto step = [&](int bh, int q0, Tile tl) {
    const size_t qoff = (size_t)bh * Sq * D;
    __syncthreads();
    load_tile<T, D>(qs, L::ROW, q + qoff, q0, min(BQ, Sq - q0));
    load_tile<T, D>(dos, L::ROW, dout + qoff, q0, min(BQ, Sq - q0));
    for (int r = tid; r < BQ; r += NTHREADS) {
      const bool ok = q0 + r < Sq;
      lse2[r] = ok ? lse[(size_t)bh * Sq + q0 + r] * LOG2E : 0.f;
      dl[r] = ok ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
    }
    __syncthreads();
    mma_tile<false, true, false>(qs, L::ROW, ks, L::KV, ss, L::SC, BQ, BK, D);
    mma_tile<false, true, false>(dos, L::ROW, vs, L::KV, dps, L::SC, BQ, BK, D);
    __syncthreads();
    // p and ds stay in registers across the barrier, then overwrite the
    // f32 tiles they were computed from
    float p[PER], ds[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NTHREADS, r = i / BK, j = i % BK;
      p[e] = 0.f;
      ds[e] = 0.f;
      bool vis = visible(q0 + r, k0 + j, Sq, Sk, causal);
      if constexpr (GATED)
        vis = vis && sub_on(tl.bits, 8 * (((q0 + r) >> gate.shift) - (q0 >> gate.shift)),
                            ((k0 + j) >> gate.shift) - (k0 >> gate.shift));
      if (vis) {
        p[e] = exp2f(ss[r * L::SC + j] * scale2 - lse2[r]);
        ds[e] = p[e] * (dps[r * L::SC + j] - dl[r]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * NTHREADS, r = i / BK, j = i % BK;
      pts[r * L::SC + j] = from_f<T>(p[e]);
      dss[r * L::SC + j] = from_f<T>(ds[e]);
    }
    __syncthreads();
    mma_tile<true, false, true>(pts, L::SC, dos, L::ROW, dvs, L::ROW, BK, D, BQ);  // dv += P^T dO
    mma_tile<true, false, true>(dss, L::SC, qs, L::ROW, dks, L::ROW, BK, D, BQ);   // dk += dS^T Q
  };
  if constexpr (GATED) {
    int first;
    const int ntiles = gate_row(gate, (kvh % gate.heads) * gridDim.x + blockIdx.x, first);
    const int nqt = (Sq + BQ - 1) / BQ;
    for (int n = 0; n < ntiles; ++n) {
      const Tile tl = tile_at<true>(gate, first, n);
      step(kvh * rep + tl.index / nqt, (tl.index % nqt) * BQ, tl);
    }
  } else {
    for (int h = 0; h < rep; ++h)
      for (int q0 = q_start; q0 < Sq; q0 += BQ) step(kvh * rep + h, q0, Tile{0, 0, 0ull});
  }
  __syncthreads();

  for (int i = tid; i < BK * D; i += NTHREADS) {
    const int r = i / D;
    if (k0 + r < Sk) {
      const size_t off = koff + (size_t)(k0 + r) * D + i % D;
      dk[off] = from_f<T>(dks[r * L::ROW + i % D] * sm_scale);
      dv[off] = from_f<T>(dvs[r * L::ROW + i % D]);
    }
  }
}

// ------------------------------------------------ forward, bf16 / fp16, wgmma
namespace hopper {

constexpr int BM = 128;                    // query rows a block: 2 warpgroups x 64
constexpr int BN = 128;                    // keys a tile
constexpr int STAGES = 3;                  // K/V ring depth
constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
constexpr uint32_t TILE = 128 * 64 * 2;    // one [128][64] bf16 tile, 16 KB

// The head dim of a wgmma kernel.  A bf16 row of D = 128 is 256 bytes, and
// a 128-byte-swizzled TMA box is at most 128 bytes wide, so a [rows][D]
// tile is D / 64 spans of [rows][64], one box each, span h (columns 64 h ..
// 64 h + 63) at h x rows x 128 bytes: a k-step of 16 over D lies in span
// kk / 4 at 32 (kk % 4) bytes, and a product whose N is D (P V, dS K, P^T
// dO, dS^T Q) is one m64n64 wgmma a span, into its own 32-register
// accumulator.  At D = 128 the accumulators of O (dQ; dK and dV) are twice
// as wide, more than the 168 registers a thread that 288 threads get, so
// the forward's and dq's producer is a whole warpgroup that hands
// registers to the consumers with setmaxnreg (24 and 240 a thread; dkv
// had one already, at 40 and 232), and the forward's ring of 32 KB K and
// V tiles is 2 stages deep (5 tiles, 161 KB).
template <int D>
struct Head {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int SPANS = D / 64;
  static constexpr int KSTEPS = D / 16;
  static constexpr int THREADS = D == 64 ? CONSUMERS + 32 : CONSUMERS + 128;
  static constexpr int FWD_STAGES = D == 64 ? STAGES : 2;
};

// Q, the ring of K and V tiles, 2 * stages + 1 mbarriers, and slack to
// align to 1024
template <int D>
constexpr size_t wgmma_fwd_smem() {
  return 1024 + TILE * Head<D>::SPANS * (1 + 2 * Head<D>::FWD_STAGES) + 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` of the barrier has completed.
// WATCH (a gated kernel's consumers, at their first waits, where a list
// the producer never walks would leave them): a wait still spinning after
// 1024 tries starts a clock, and traps once it reads 10 s, so that it
// fails the launch with an error instead of hanging.  (In the loops the
// watch's registers cost dkv its wgmma overlap: ptxas C7512.)
template <bool WATCH = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t t0 = 0;
  uint32_t spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if constexpr (WATCH) {
      if (!done && (++spins & 1023u) == 0) {
        const uint64_t t = globaltimer_ns();
        if (t0 == 0) t0 = t;
        else if (t - t0 > 10000000000ull) __trap();
      }
    }
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completion is counted in
// bytes on `bar`.  Rows past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of accumulator registers above the
// wgmma.wait_group that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int S, int N>
__device__ __forceinline__ void fence_regs(float (&r)[S][N]) {
#pragma unroll
  for (int s = 0; s < S; ++s) fence_regs(r[s]);
}

// The forward's and dq's register budget at D = 128 (Head): the producer
// warpgroup gives registers back, the consumers take them (dkv keeps its
// 40 / 232 at both head dims: its producer loads lse and delta itself).
template <int D>
__device__ __forceinline__ void producer_regs() {
  if constexpr (D == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
template <int D>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (D == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// One arrival of the calling warp on a stage's empty barrier.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The element type E of a wgmma kernel, bf16 or fp16 (__half): the two
// differ only in the wgmma instruction's input type (.bf16 / .f16), the
// TMA element type and the round-to-nearest pack of two f32 into a 32-bit
// pair.  fp16's pack rounds a value past 65504 to inf, as the TPU kernels'
// astype does; nothing is clamped, so an overflowing dS or dq reaches the
// loss scaler as inf.
template <typename E> struct Elt;
template <> struct Elt<bf16> {
  using E2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ E2 pack2(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpack2(E2 x) { return __bfloat1622float2(x); }
};
template <> struct Elt<__half> {
  using E2 = __half2;
  static constexpr CUtensorMapDataType TMA = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ E2 pack2(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpack2(E2 x) { return __half22float2(x); }
};
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

// Two f32 as one 32-bit register of the E pair (a wgmma A operand).
template <typename E>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  const typename Elt<E>::E2 v = Elt<E>::pack2(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define WGMMA_M64N128K16_SS(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(accumulate))
// D[64 x 128] (f32, 64 registers a thread) (+)= A[64 x 16] * B[16 x 128],
// A and B K-major in shared memory (descriptors da, db)
template <typename E>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  if constexpr (kIsF16<E>) WGMMA_M64N128K16_SS("f16");
  else WGMMA_M64N128K16_SS("bf16");
}
#define WGMMA_M64N64K16_SS(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(accumulate))
// D[64 x 64] (f32, 32 registers a thread) (+)= A[64 x 16] * B[16 x 64], A
// and B K-major in shared memory (descriptors da, db)
template <typename E>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  if constexpr (kIsF16<E>) WGMMA_M64N64K16_SS("f16");
  else WGMMA_M64N64K16_SS("bf16");
}
#define WGMMA_M64N64K16_RS(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
// D[64 x 64] (f32) += A[64 x 16] * B[16 x 64], A in registers (four E pairs a
// thread, the accumulator's fragment layout), B MN-major in shared memory
template <typename E>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  if constexpr (kIsF16<E>) WGMMA_M64N64K16_RS("f16");
  else WGMMA_M64N64K16_RS("bf16");
}


// sc = Q K^T for this warpgroup's 64 rows against the [128][D] K tile at
// ks: D / 16 k-steps of 16, 32 bytes apart in the swizzled 128-byte rows of
// a span, the spans of both 128-row tiles TILE apart (committed by the
// caller).
template <typename E, int D>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t qa, uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Head<D>::KSTEPS; ++kk)
    wgmma_m64n128k16_ss<E>(sc, desc_sw128(qa + TILE * (kk / 4) + 32 * (kk % 4), 16, 1024),
                        desc_sw128(ks + TILE * (kk / 4) + 32 * (kk % 4), 16, 1024), kk);
}

// The online-softmax step on the S fragments of the tile at key k0 (exp2
// domain): masks keys >= Sk and, under causal, above the diagonal; updates
// the running max m_r and sum l_r of the thread's two rows, leaves P in sc
// GATED masking of a score fragment x[N] (column pairs j = i >> 2, rows r
// = (i >> 1) & 1), in a pass of its own before the softmax, taken only on
// a tile that is not FULL: -inf where the key's layout sub-block is off
// for the thread's two rows (one sub-block: bit j of pm, pair_bits) and,
// on a DIAG tile, after each row (column 8 j + 2 quad + (i & 1) >
// row: 8 j + (i & 1) > row - k0 - 2 quad).  Masking inside the softmax's
// loop instead, as the ungated path does on its edge tiles, slowed the
// gated kernels even on tiles that were never masked (PERF.md §6).
template <int N>
__device__ __forceinline__ void gate_pass(float (&x)[N], int flags, uint32_t pm, int k0, int row0,
                                          int quad) {
  if (flags & FULL) return;
  const bool diag = flags & DIAG;
  const int lim0 = row0 - k0 - 2 * quad;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int lim = lim0 + 8 * ((i >> 1) & 1);
    if (!((pm >> (i >> 2)) & 1u) || (diag && 8 * (i >> 2) + (i & 1) > lim)) x[i] = neg_inf();
  }
}

// and the factor O must be rescaled by in alpha.  GATED: the masking is
// gate_pass's, before this step's loop, which then runs unmasked.
template <bool GATED>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int k0, int row0, int quad,
                                             int wg_first, int Sk, int causal, float scale2,
                                             int flags, uint32_t pm) {
  const float kNegInf = neg_inf();
  bool edge = false;
  if constexpr (GATED) gate_pass(sc, flags, pm, k0, row0, quad);
  else edge = k0 + BN > Sk || (causal && k0 + BN - 1 > wg_first);
  // row max and row sum in four independent chains a row (column chunk j
  // goes to chain j % 4), so that two warps a scheduler keep it busy
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mx[0][c] = mx[1][c] = kNegInf;
    sum[0][c] = sum[1][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (edge) {
      const int col = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (col >= Sk || (causal && col > row)) sc[i] = kNegInf;
    }
    mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_r[r], m * scale2);
    base[r] = m_new == kNegInf ? 0.f : m_new;            // a row with no key yet
    alpha[r] = ex2(m_r[r] - base[r]);
    m_r[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], scale2, -base[r]));
    sc[i] = p;
    sum[r][(i >> 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_r[r] = l_r[r] * alpha[r] + l;
  }
}

// An accumulator of KS k-steps' width (P, dS) as the register A operand:
// k-step kk (columns 16kk..16kk+15) is the accumulator's column chunks 2kk
// and 2kk+1.
template <typename E, int KS>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KS][4], const float (&sc)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    pa[kk][0] = pack16<E>(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack16<E>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack16<E>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack16<E>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O = alpha O + P V, issued (committed by the caller): V's [128 keys][D]
// tile at vs read MN-major, span h into acc[h]; a k-step is 16 key rows,
// two 1024-byte groups of 8 rows.
template <typename E, int SPANS>
__device__ __forceinline__ void rescale_and_issue_pv(float (&acc)[SPANS][32],
                                                     const uint32_t (&pa)[8][4],
                                                     const float (&alpha)[2], uint32_t vs) {
#pragma unroll
  for (int h = 0; h < SPANS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < SPANS; ++h)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_m64n64k16_rs<E>(acc[h], pa[kk], desc_sw128(vs + TILE * h + 2048 * kk, 1024, 1024));
}

// 128 rows of a [BH, S, 64] E array from row0 of head bh set to zero
// (rows >= S left alone), by all the block's threads: the output of a
// gated kernel's query tile that sees no key tile.
template <typename E>
__device__ void zero_rows(E* x, int bh, int row0, int S) {
  using E2 = typename Elt<E>::E2;
  const E2 zero = Elt<E>::pack2(0.f, 0.f);
  for (int i = threadIdx.x; i < BM * 32; i += blockDim.x) {
    const int row = row0 + i / 32;
    if (row < S) reinterpret_cast<E2*>(x)[((size_t)bh * S + row) * 32 + i % 32] = zero;
  }
}

// Accumulator fragments of m64nN (f32): register i of a thread of warp w
// holds row 16*w + lane/4 + 8*((i >> 1) & 1), column 8*(i >> 2) + 2*(lane%4)
// + (i & 1) of its warpgroup's 64-row tile.  GATED: the ring walks the
// live key tiles of the query tile's map row (stage = list position).
// E: bf16 or fp16 (Elt), the same kernel.
template <typename E, bool GATED, int D>
__global__ void __launch_bounds__(Head<D>::THREADS, 1)
wgmma_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, E* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int rep, int causal, float scale2,
                 const Gate gate) {
  static_assert(!GATED || D == 64, "the layout gate runs at head dim 64");
  constexpr int SPANS = Head<D>::SPANS, NST = Head<D>::FWD_STAGES;
  constexpr uint32_t T = TILE * SPANS;              // one [128][D] E tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(smem);            // 1024-aligned: the swizzle's period
  const uint32_t q_s = sbase;                       // [128][D] E
  const uint32_t bars = sbase + T * (1 + 2 * NST);
  const uint32_t full0 = bars, empty0 = bars + 8 * NST, qbar = bars + 16 * NST;

  StageTile* descs = reinterpret_cast<StageTile*>(smem + T * (1 + 2 * NST) + 64);

  // ungated: block (bh, the longest causal rows first); GATED: block
  // (batch, the map row of the order's entry blockIdx.y), the longest
  // lists of live tiles first
  int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BM, map_row = 0;
  if constexpr (GATED) {
    map_row = __ldg(gate.order + blockIdx.y);
    const int nt = gridDim.y / gate.heads;
    bh = blockIdx.x * gate.heads + map_row / nt;
    q0 = (map_row % nt) * BM;
  }
  const int kvh = bh / rep;
  const int k_end = causal ? min(Sk, min(q0 + BM, Sq)) : Sk;
  int first = 0, ntiles = (k_end + BN - 1) / BN;
  const int tid = threadIdx.x;
  if constexpr (GATED) {
    ntiles = gate_row(gate, map_row, first);
    if (ntiles == 0) {                              // no key: o = 0, lse = -inf
      zero_rows<E>(o, bh, q0, Sq);
      for (int r = tid; r < BM && q0 + r < Sq; r += THREADS)
        lse[(size_t)bh * Sq + q0 + r] = neg_inf();
      return;
    }
  }

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);    // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                           // producer: one thread issues
    producer_regs<D>();
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, T);
#pragma unroll
      for (int h = 0; h < SPANS; ++h) tma_load_3d(q_s + TILE * h, &tq, qbar, 64 * h, q0, bh);
      Tile next = tile_at<GATED>(gate, first, 0);  // GATED: entry t + 1 loads during wait t
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % NST;
        const Tile tl = next;
        if (t + 1 < ntiles) next = tile_at<GATED>(gate, first, t + 1);
        mbar_wait(empty0 + 8 * s, ((t / NST) & 1) ^ 1);       // first pass: free
        const uint32_t ks = sbase + T * (1 + 2 * s);
        if constexpr (GATED) descs[s] = StageTile{tl.index, tl.flags, tl.bits};
        mbar_expect_tx(full0 + 8 * s, 2 * T);
#pragma unroll
        for (int h = 0; h < SPANS; ++h) {
          tma_load_3d(ks + TILE * h, &tk, full0 + 8 * s, 64 * h, tl.index * BN, kvh);
          tma_load_3d(ks + T + TILE * h, &tv, full0 + 8 * s, 64 * h, tl.index * BN, kvh);
        }
      }
    }
    return;
  }
  consumer_regs<D>();

  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int quad = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // rows row0 and row0 + 8
  const int wg_first = q0 + wg * 64;
  const uint32_t qa = q_s + wg * 64 * 128;                // this warpgroup's 64 Q rows
  // GATED: the thread's query sub-block x 8, and tile t's key offset, FULL
  // flag and the 8-key runs its sub-block's row lets through, from the
  // stage descriptor
  const int qbit = GATED ? 8 * ((row0 >> gate.shift) - (q0 >> gate.shift)) : 0;
  auto stage_tile = [&](int t, int& k0, int& flags, uint32_t& pm) {
    if constexpr (GATED) {
      const StageTile d = descs[t % NST];
      k0 = d.index * BN;
      flags = d.flags;
      pm = flags & FULL ? 0u : pair_bits((uint32_t)(d.bits >> qbit) & 0xffu, gate.shift, BN / 8);
    } else {
      k0 = t * BN;
      flags = 0;
      pm = 0;
    }
  };

  const float kNegInf = neg_inf();
  float acc[SPANS][32];                                   // O, span h in acc[h]
#pragma unroll
  for (int h = 0; h < SPANS; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  // running row max (scaled, exp2 domain; -inf until a key is seen) and sum
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float sc[64];                                           // S of the tile in hand
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  mbar_wait<GATED>(qbar, 0);
  mbar_wait<GATED>(full0, 0);
  issue_scores<E, D>(sc, qa, sbase + T);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  // Per tile t: the softmax of S_t runs while P_{t-1} V_{t-1} is still on
  // the tensor cores; then P_{t-1} V_{t-1} is retired (its stage released
  // to the producer), P_t packed, S_{t+1} issued, O rescaled, P_t V_t
  // issued, and S_{t+1} awaited.  The last tile is peeled off so that no
  // wgmma or wait in the loop is conditional (ptxas serializes every wgmma
  // of a kernel when it cannot prove a pipeline stage closed on every path).
  float alpha[2];
  uint32_t pa[8][4];
  for (int t = 0; t + 1 < ntiles; ++t) {
    int k0, flags;
    uint32_t pm;
    stage_tile(t, k0, flags, pm);
    softmax_tile<GATED>(sc, m_r, l_r, alpha, k0, row0, quad, wg_first, Sk, causal, scale2, flags,
                        pm);
    wgmma_wait<0>();                                      // P_{t-1} V_{t-1}
    fence_regs(acc);
    if (t > 0) release(empty0 + 8 * ((t - 1) % NST), lane);
    pack_p<E>(pa, sc);
    const int s1 = (t + 1) % NST;
    mbar_wait(full0 + 8 * s1, ((t + 1) / NST) & 1);
    issue_scores<E, D>(sc, qa, sbase + T * (1 + 2 * s1));   // S_{t+1}
    wgmma_commit();
    rescale_and_issue_pv<E>(acc, pa, alpha, sbase + T * (2 + 2 * (t % NST)));
    wgmma_commit();
    wgmma_wait<1>();                                      // S_{t+1}
    fence_regs(sc);
  }
  {
    const int t = ntiles - 1;
    int k0, flags;
    uint32_t pm;
    stage_tile(t, k0, flags, pm);
    softmax_tile<GATED>(sc, m_r, l_r, alpha, k0, row0, quad, wg_first, Sk, causal, scale2, flags,
                        pm);
    wgmma_wait<0>();
    fence_regs(acc);
    pack_p<E>(pa, sc);
    rescale_and_issue_pv<E>(acc, pa, alpha, sbase + T * (2 + 2 * (t % NST)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float lr = l_r[r] == 0.f ? 1.f : l_r[r];
    auto* orow = reinterpret_cast<typename Elt<E>::E2*>(o + ((size_t)bh * Sq + row) * D);
#pragma unroll
    for (int h = 0; h < SPANS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[32 * h + 4 * j + quad] = Elt<E>::pack2(acc[h][4 * j + 2 * r] / lr,
                                                    acc[h][4 * j + 2 * r + 1] / lr);
    if (quad == 0) lse[(size_t)bh * Sq + row] = m_r[r] * LN2 + logf(lr);
  }
}

// ----------------------------------------------- backward, bf16 / fp16, wgmma
constexpr int KT = 64;                     // keys a dq tile, queries a dkv tile
constexpr uint32_t HALF = 64 * 64 * 2;     // one [64][64] bf16 tile, 8 KB
// dq: Q and dO, the ring of K and V tiles, 2 * STAGES + 1 mbarriers
template <int D>
constexpr size_t dq_smem() {
  return 1024 + (2 * TILE + STAGES * 2 * HALF) * Head<D>::SPANS + 8 * (2 * STAGES + 1);
}
// dkv: K and V, the ring of Q and dO tiles with their lse and delta rows
// (2 x 64 floats a stage; GATED 8 lse rows, one per key sub-block of the
// tile, then delta and the tile's first query row), 2 * STAGES + 1
// mbarriers
template <bool GATED>
__host__ __device__ constexpr int dkv_lse_rows() { return GATED ? 8 : 1; }
template <bool GATED>
__host__ __device__ constexpr uint32_t dkv_side() {
  return (dkv_lse_rows<GATED>() + 1) * 64 * 4 + (GATED ? 16 : 0);
}
template <bool GATED, int D>
constexpr size_t dkv_smem() {
  return 1024 + 2 * TILE * Head<D>::SPANS +
         STAGES * (2 * HALF * Head<D>::SPANS + dkv_side<GATED>()) + 8 * (2 * STAGES + 1);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// D = A B^T over D for this warpgroup's 64 rows of the K-major tile at a
// against the 64 rows of the K-major tile at b: D / 16 k-steps of 16, 32
// bytes apart in the swizzled 128-byte rows of a span, the spans of a and
// of b a_span and b_span bytes apart (committed by the caller, after a
// wgmma_fence).
template <typename E, int D>
__device__ __forceinline__ void issue_nt(float (&d)[32], uint32_t a, uint32_t a_span, uint32_t b,
                                         uint32_t b_span) {
#pragma unroll
  for (int kk = 0; kk < Head<D>::KSTEPS; ++kk)
    wgmma_m64n64k16_ss<E>(d, desc_sw128(a + a_span * (kk / 4) + 32 * (kk % 4), 16, 1024),
                       desc_sw128(b + b_span * (kk / 4) + 32 * (kk % 4), 16, 1024), kk);
}

// d[h] += A B_h, A the 64 x 64 register operand pa and B_h span h of the
// [64][D] tile at b (spans b_span bytes apart) read MN-major: a k-step is
// 16 rows of b, two 1024-byte groups of 8.
template <typename E, int SPANS>
__device__ __forceinline__ void issue_rs(float (&d)[SPANS][32], const uint32_t (&pa)[4][4],
                                         uint32_t b, uint32_t b_span) {
#pragma unroll
  for (int h = 0; h < SPANS; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs<E>(d[h], pa[kk], desc_sw128(b + b_span * h + 2048 * kk, 1024, 1024));
}

// dq's step on the fragments of the 64-key tile at k0 (rows: the thread's
// two query rows row0, row0 + 8): P = exp2(S scale2 - lse2[row]), zero for
// keys >= Sk and, under causal, above the diagonal; dS = P (dP -
// delta[row]) is left in s.  GATED: x = S scale2 - lse2 first, then
// gate_pass on x (never on S: a row that sees no key has lse2 = -inf,
// and -inf - (-inf) would be NaN), then the exp2.
template <bool GATED>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32],
                                        const float (&lse2)[2], const float (&dl)[2], int k0,
                                        int row0, int quad, bool edge, int Sk, int causal,
                                        float scale2, int flags, uint32_t pm) {
  if constexpr (GATED) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = fmaf(s[i], scale2, -lse2[(i >> 1) & 1]);
    gate_pass(s, flags, pm, k0, row0, quad);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(s[i]) * (dp[i] - dl[(i >> 1) & 1]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = fmaf(s[i], scale2, -lse2[r]);
    if (edge) {
      const int col = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
      if (col >= Sk || (causal && col > row0 + 8 * r)) x = neg_inf();
    }
    s[i] = ex2(x) * (dp[i] - dl[r]);
  }
}

// dkv's step on the fragments of the transposed tile (rows: the thread's
// two keys key0, key0 + 8; columns: the 64 queries from q0, whose lse2 and
// delta lie in shared memory at lrow and drow): P^T is left in s and dS^T
// in dp.  Queries >= Sq carry lse2 = +inf (P = 0); under causal (edge) a
// key above the query's diagonal is masked.  GATED, lrow is the row of
// the keys' layout sub-block, where a query whose sub-block bit is 0 also
// carries lse2 = +inf, so the layout costs the step nothing.
// LEAN (D = 128, where dK and dV hold 128 registers a thread): the lse and
// delta pairs are read one column pair j at a time instead of all first.
template <bool LEAN = false>
__device__ __forceinline__ void ds_cols(float (&s)[32], float (&dp)[32], const float* lrow,
                                        const float* drow, int q0, int key0, int quad, bool edge,
                                        float scale2) {
  auto col = [&](int i, float2 l2, float2 dl) {
    const float lc = (i & 1) ? l2.y : l2.x;
    const float dc = (i & 1) ? dl.y : dl.x;
    float x = fmaf(s[i], scale2, -lc);
    if (edge && q0 + 8 * (i >> 2) + 2 * quad + (i & 1) < key0 + 8 * ((i >> 1) & 1)) x = neg_inf();
    const float p = ex2(x);
    s[i] = p;
    dp[i] = p * (dp[i] - dc);
  };
  if constexpr (LEAN) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * j + 2 * quad);
      const float2 dl = *reinterpret_cast<const float2*>(drow + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) col(4 * j + e, l2, dl);
    }
    return;
  }
  float2 l2[8], dl[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    l2[j] = *reinterpret_cast<const float2*>(lrow + 8 * j + 2 * quad);
    dl[j] = *reinterpret_cast<const float2*>(drow + 8 * j + 2 * quad);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) col(i, l2[i >> 2], dl[i >> 2]);
}

// 16 E at p (16-byte aligned) summed against 16 at q, in f32.
template <typename E>
__device__ __forceinline__ float dot16(const E* p, const E* q) {
  using E2 = typename Elt<E>::E2;
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[h], b = reinterpret_cast<const uint4*>(q)[h];
    const E2* a2 = reinterpret_cast<const E2*>(&a);
    const E2* b2 = reinterpret_cast<const E2*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = Elt<E>::unpack2(a2[e]), y = Elt<E>::unpack2(b2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// lse (exp2 domain) and delta of the thread's two rows row0, row0 + 8 of
// head bh; with o given, delta = rowsum(dO O) in f32, the row's quad
// reading 16 values a span each, and written out for the dkv call.
template <typename E, int D>
__device__ __forceinline__ void dq_row_stats(const E* o, const E* dout, const float* lse,
                                             float* delta, int bh, int Sq, int row0, int quad,
                                             float (&lse2)[2], float (&dl)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t ri = (size_t)bh * Sq + row;
    if (o != nullptr) {
      float d = row < Sq ? dot16(dout + ri * D + 16 * quad, o + ri * D + 16 * quad) : 0.f;
      if constexpr (D == 128) {
        if (row < Sq) d += dot16(dout + ri * D + 64 + 16 * quad, o + ri * D + 64 + 16 * quad);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (quad == 0 && row < Sq) delta[ri] = d;
      dl[r] = d;
    } else {
      dl[r] = row < Sq ? delta[ri] : 0.f;
    }
    lse2[r] = row < Sq ? lse[ri] * LOG2E : 0.f;
  }
}

// Fragments as in wgmma_fwd_kernel.  Per 64-key tile t: dS_t is computed
// while dS_{t-1} K_{t-1} is still on the tensor cores; then that product is
// retired (its stage released), dS_t packed, S_{t+1} and dP_{t+1} issued,
// dS_t K_t issued, and S_{t+1}, dP_{t+1} awaited.  The last tile is peeled
// off so that no wgmma or wait in the loop is conditional.  GATED: the
// ring walks the live 64-key tiles of the query tile's map row.
template <typename E, bool GATED, int D>
__global__ void __launch_bounds__(Head<D>::THREADS, 1)
wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const E* __restrict__ o, const E* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta, E* __restrict__ dq,
                int Sq, int Sk, int rep, int causal, float sm_scale, const Gate gate) {
  static_assert(!GATED || D == 64, "the layout gate runs at head dim 64");
  constexpr int SPANS = Head<D>::SPANS;
  constexpr uint32_t T = TILE * SPANS, KV = HALF * SPANS;   // [128][D], [64][D]
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t q_s = sbase, do_s = sbase + T;     // [128][D] E each
  const uint32_t ring = sbase + 2 * T;               // stage s: K, V [64][D]
  const uint32_t bars = ring + STAGES * 2 * KV;
  const uint32_t full0 = bars, empty0 = bars + 8 * STAGES, qbar = bars + 16 * STAGES;

  StageTile* descs = reinterpret_cast<StageTile*>(smem + 2 * T + STAGES * 2 * KV + 64);

  // blocks as in wgmma_fwd_kernel
  int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * BM, map_row = 0;
  if constexpr (GATED) {
    map_row = __ldg(gate.order + blockIdx.y);
    const int nt = gridDim.y / gate.heads;
    bh = blockIdx.x * gate.heads + map_row / nt;
    q0 = (map_row % nt) * BM;
  }
  const int kvh = bh / rep;
  const int k_end = causal ? min(Sk, min(q0 + BM, Sq)) : Sk;
  int first = 0, ntiles = (k_end + KT - 1) / KT;
  const int tid = threadIdx.x;
  if constexpr (GATED) {
    ntiles = gate_row(gate, map_row, first);
    if (ntiles == 0) {                              // no key: dq = 0, delta still written
      if (tid < CONSUMERS) {
        const int lane = tid % 32;
        float lse2[2], dl[2];
        dq_row_stats<E, D>(o, dout, lse, delta, bh, Sq, q0 + (tid / 32) * 16 + lane / 4, lane % 4,
                        lse2, dl);
      }
      zero_rows<E>(dq, bh, q0, Sq);
      return;
    }
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                          // producer: one thread issues
    producer_regs<D>();
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, 2 * T);
#pragma unroll
      for (int h = 0; h < SPANS; ++h) {
        tma_load_3d(q_s + TILE * h, &tq, qbar, 64 * h, q0, bh);
        tma_load_3d(do_s + TILE * h, &tdo, qbar, 64 * h, q0, bh);
      }
      Tile next = tile_at<GATED>(gate, first, 0);  // GATED: entry t + 1 loads during wait t
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const Tile tl = next;
        if (t + 1 < ntiles) next = tile_at<GATED>(gate, first, t + 1);
        mbar_wait(empty0 + 8 * s, ((t / STAGES) & 1) ^ 1);
        const uint32_t ks = ring + 2 * KV * s;
        if constexpr (GATED) descs[s] = StageTile{tl.index, tl.flags, tl.bits};
        mbar_expect_tx(full0 + 8 * s, 2 * KV);
#pragma unroll
        for (int h = 0; h < SPANS; ++h) {
          tma_load_3d(ks + HALF * h, &tk, full0 + 8 * s, 64 * h, tl.index * KT, kvh);
          tma_load_3d(ks + KV + HALF * h, &tv, full0 + 8 * s, 64 * h, tl.index * KT, kvh);
        }
      }
    }
    return;
  }
  consumer_regs<D>();

  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int quad = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // rows row0 and row0 + 8
  const int wg_first = q0 + wg * 64;
  const uint32_t qa = q_s + wg * 64 * 128, doa = do_s + wg * 64 * 128;
  // as in wgmma_fwd_kernel; ungated, edge marks the tiles the mask reaches
  const int qbit = GATED ? 8 * ((row0 >> gate.shift) - (q0 >> gate.shift)) : 0;
  auto stage_tile = [&](int t, int& k0, bool& edge, int& flags, uint32_t& pm) {
    if constexpr (GATED) {
      const StageTile d = descs[t % STAGES];
      k0 = d.index * KT;
      flags = d.flags;
      edge = false;
      pm = flags & FULL ? 0u : pair_bits((uint32_t)(d.bits >> qbit) & 0xffu, gate.shift, KT / 8);
    } else {
      k0 = t * KT;
      edge = k0 + KT > Sk || (causal && k0 + KT - 1 > wg_first);
      flags = 0;
      pm = 0;
    }
  };

  float lse2[2], dl[2];
  dq_row_stats<E, D>(o, dout, lse, delta, bh, Sq, row0, quad, lse2, dl);
  const float scale2 = sm_scale * LOG2E;

  float acc[SPANS][32], s[32], dp[32];                    // dQ span h in acc[h]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int h = 0; h < SPANS; ++h) acc[h][i] = 0.f;
  }
  uint32_t pa[4][4];

  mbar_wait<GATED>(qbar, 0);
  mbar_wait<GATED>(full0, 0);
  wgmma_fence();
  issue_nt<E, D>(s, qa, TILE, ring, HALF);
  issue_nt<E, D>(dp, doa, TILE, ring + KV, HALF);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  for (int t = 0; t + 1 < ntiles; ++t) {
    int k0, flags;
    bool edge;
    uint32_t pm;
    stage_tile(t, k0, edge, flags, pm);
    ds_rows<GATED>(s, dp, lse2, dl, k0, row0, quad, edge, Sk, causal, scale2, flags, pm);
    wgmma_wait<0>();                                      // dS_{t-1} K_{t-1}
    fence_regs(acc);
    if (t > 0) release(empty0 + 8 * ((t - 1) % STAGES), lane);
    pack_p<E>(pa, s);
    const int s1 = (t + 1) % STAGES;
    mbar_wait(full0 + 8 * s1, ((t + 1) / STAGES) & 1);
    wgmma_fence();
    issue_nt<E, D>(s, qa, TILE, ring + 2 * KV * s1, HALF);          // S_{t+1}
    issue_nt<E, D>(dp, doa, TILE, ring + 2 * KV * s1 + KV, HALF);   // dP_{t+1}
    wgmma_commit();
    issue_rs<E>(acc, pa, ring + 2 * KV * (t % STAGES), HALF);       // dQ += dS_t K_t
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
  }
  {
    const int t = ntiles - 1;
    int k0, flags;
    bool edge;
    uint32_t pm;
    stage_tile(t, k0, edge, flags, pm);
    ds_rows<GATED>(s, dp, lse2, dl, k0, row0, quad, edge, Sk, causal, scale2, flags, pm);
    wgmma_wait<0>();
    fence_regs(acc);
    pack_p<E>(pa, s);
    wgmma_fence();
    issue_rs<E>(acc, pa, ring + 2 * KV * (t % STAGES), HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    auto* out = reinterpret_cast<typename Elt<E>::E2*>(dq + ((size_t)bh * Sq + row) * D);
#pragma unroll
    for (int h = 0; h < SPANS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        out[32 * h + 4 * j + quad] = Elt<E>::pack2(acc[h][4 * j + 2 * r] * sm_scale,
                                                   acc[h][4 * j + 2 * r + 1] * sm_scale);
  }
}

// The transposed problem, fragments as in wgmma_fwd_kernel with keys for
// rows.  Query tile n (64 rows of query head kvh * rep + n / nqt) walks the
// ring as the key tiles do in wgmma_dq_kernel: P^T_n and dS^T_n are
// computed while dV += P^T_{n-1} dO_{n-1} and dK += dS^T_{n-1} Q_{n-1} are
// in flight.  The warpgroup whose keys all lie below a diagonal tile's
// queries computes zeros there, and keeps to the ring's protocol.  Four
// 32-float accumulators, the two packed operands and the next tile's
// products in flight need more than the 168 registers a thread that 288
// threads get (ptxas spilled and serialised every wgmma), so the producer
// is a whole warpgroup that hands registers to the consumers with
// setmaxnreg (40 and 232 a thread), and one warp of it works.  GATED: the
// blocks follow the map's order (batch, the longest column lists first);
// tile n is entry n of the key tile's column list, g * nqt + query tile
// over all nqt query tiles, with query head kvh * rep + g under its own
// layout head; a key tile no query sees writes zeros, as under causal.
// The producer writes each query row's lse once per key sub-block, +inf
// where the layout gates the pair off.  D = 128: dK and dV alone take 128
// registers a thread, and with S^T, dP^T and their packed operands the
// overlapped loop would need about 245 of the 232 a consumer gets, so each
// tile's products run in turn (S^T and dP^T, then dV and dK: about 220),
// and the lse and delta pairs are read a column pair at a time
// (ds_cols<true>).
constexpr int DKV_THREADS = CONSUMERS + 128;
template <typename E, bool GATED, int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
wgmma_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 E* __restrict__ dk, E* __restrict__ dv, int Sq, int Sk, int rep,
                 int causal, float sm_scale, const Gate gate) {
  static_assert(!GATED || D == 64, "the layout gate runs at head dim 64");
  constexpr int SPANS = Head<D>::SPANS;
  constexpr uint32_t T = TILE * SPANS, QT = HALF * SPANS;   // [128][D], [64][D]
  // ungated: the key tiles that see the most queries first
  int kvh = blockIdx.x, k0 = blockIdx.y * BM, map_row = 0;
  if constexpr (GATED) {
    map_row = __ldg(gate.order + blockIdx.y);
    const int nt = gridDim.y / gate.heads;
    kvh = blockIdx.x * gate.heads + map_row / nt;
    k0 = (map_row % nt) * BM;
  }
  // queries above the diagonal see none of these keys; GATED: the list's
  // query tiles count from 0
  const int q_start = causal && !GATED ? k0 : 0;
  const int nqt = q_start < Sq ? (Sq - q_start + KT - 1) / KT : 0;
  int first = 0, ntiles = rep * nqt;
  if constexpr (GATED) ntiles = gate_row(gate, map_row, first);
  const int tid = threadIdx.x;
  if (ntiles == 0) {                       // no query sees these keys
    using E2 = typename Elt<E>::E2;
    const E2 zero = Elt<E>::pack2(0.f, 0.f);
    for (int i = tid; i < BM * (D / 2); i += DKV_THREADS) {
      const int key = k0 + i / (D / 2);
      if (key >= Sk) continue;
      const size_t off = ((size_t)kvh * Sk + key) * (D / 2) + i % (D / 2);
      reinterpret_cast<E2*>(dk)[off] = zero;
      reinterpret_cast<E2*>(dv)[off] = zero;
    }
    return;
  }

  constexpr uint32_t SIDE = dkv_side<GATED>();
  constexpr int LROWS = dkv_lse_rows<GATED>();       // delta at side + 64 LROWS
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t k_s = sbase, v_s = sbase + T;      // [128][D] E each
  const uint32_t ring = sbase + 2 * T;               // stage s: Q, dO [64][D]
  float* side0 = reinterpret_cast<float*>(smem + 2 * T + STAGES * 2 * QT);
  const uint32_t bars = ring + STAGES * (2 * QT + SIDE);
  const uint32_t full0 = bars, empty0 = bars + 8 * STAGES, kvbar = bars + 16 * STAGES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);              // every producer lane, one with expect_tx
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {                        // producer warpgroup: one warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid >= CONSUMERS + 32) return;
    const int lane = tid - CONSUMERS;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * T);
#pragma unroll
      for (int h = 0; h < SPANS; ++h) {
        tma_load_3d(k_s + TILE * h, &tk, kvbar, 64 * h, k0, kvh);
        tma_load_3d(v_s + TILE * h, &tv, kvbar, 64 * h, k0, kvh);
      }
    }
    Tile next = tile_at<GATED>(gate, first, 0);    // GATED: entry n + 1 loads during wait n
    for (int n = 0; n < ntiles; ++n) {
      const int s = n % STAGES;
      const Tile tl = next;
      if (n + 1 < ntiles) next = tile_at<GATED>(gate, first, n + 1);
      const int bh = kvh * rep + tl.index / nqt, q0 = q_start + (tl.index % nqt) * KT;
      mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
      float* side = side0 + s * (SIDE / 4);
#pragma unroll
      for (int r = lane; r < KT; r += 32) {
        const int row = q0 + r;
        const bool ok = row < Sq;
        const float l2 = ok ? lse[(size_t)bh * Sq + row] * LOG2E : pos_inf();
        side[LROWS * KT + r] = ok ? delta[(size_t)bh * Sq + row] : 0.f;
        if constexpr (GATED) {  // one lse row per key sub-block
          const int qb = (row >> gate.shift) - (q0 >> gate.shift);
          const uint32_t kb = (uint32_t)(tl.bits >> (8 * qb));
#pragma unroll
          for (int b = 0; b < LROWS; ++b) side[b * KT + r] = (kb >> b) & 1u ? l2 : pos_inf();
        } else {
          side[r] = l2;
        }
      }
      if constexpr (GATED) {
        if (lane == 0) reinterpret_cast<int*>(side + (LROWS + 1) * KT)[0] = q0;
      }
      if (lane == 0) {
        const uint32_t qs = ring + 2 * QT * s;
        mbar_expect_tx(full0 + 8 * s, 2 * QT);
#pragma unroll
        for (int h = 0; h < SPANS; ++h) {
          tma_load_3d(qs + HALF * h, &tq, full0 + 8 * s, 64 * h, q0, bh);
          tma_load_3d(qs + QT + HALF * h, &tdo, full0 + 8 * s, 64 * h, q0, bh);
        }
      } else {
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int quad = lane % 4;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;   // keys key0 and key0 + 8
  const int wg_last = k0 + wg * 64 + 63;
  const uint32_t ka = k_s + wg * 64 * 128, va = v_s + wg * 64 * 128;
  const float scale2 = sm_scale * LOG2E;
  // the lse row of the thread's keys (key0 and key0 + 8 share a layout
  // sub-block), and tile n's first query row (GATED: from the stage's side
  // area, written by the producer)
  const int lrow = GATED ? KT * ((key0 >> gate.shift) - (k0 >> gate.shift)) : 0;
  auto tile_q0 = [&](int n, const float* side) {
    if constexpr (GATED) return reinterpret_cast<const int*>(side + (LROWS + 1) * KT)[0];
    else return q_start + (n % nqt) * KT;
  };

  float dka[SPANS][32], dva[SPANS][32], s[32], dp[32];   // dK, dV span h in [h]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int h = 0; h < SPANS; ++h) dka[h][i] = dva[h][i] = 0.f;
  }
  uint32_t pp[4][4], pd[4][4];

  if constexpr (D == 128) {              // each tile's products in turn
    mbar_wait(kvbar, 0);
    for (int n = 0; n < ntiles; ++n) {
      const int st = n % STAGES;
      const float* side = side0 + st * (SIDE / 4);
      const int q0 = tile_q0(n, side);
      const uint32_t qn = ring + 2 * QT * st;
      mbar_wait(full0 + 8 * st, (n / STAGES) & 1);
      wgmma_fence();
      issue_nt<E, D>(s, ka, TILE, qn, HALF);                 // S^T_n = K Q_n^T
      issue_nt<E, D>(dp, va, TILE, qn + QT, HALF);           // dP^T_n = V dO_n^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      ds_cols<true>(s, dp, side + lrow, side + LROWS * KT, q0, key0, quad,
                    causal && q0 < wg_last, scale2);
      pack_p<E>(pp, s);
      pack_p<E>(pd, dp);
      wgmma_fence();
      issue_rs<E>(dva, pp, qn + QT, HALF);                   // dV += P^T_n dO_n
      issue_rs<E>(dka, pd, qn, HALF);                        // dK += dS^T_n Q_n
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      release(empty0 + 8 * st, lane);
    }
  } else {
    mbar_wait<GATED>(kvbar, 0);
    mbar_wait<GATED>(full0, 0);
    wgmma_fence();
    issue_nt<E, D>(s, ka, TILE, ring, HALF);                   // S^T_0 = K Q_0^T
    issue_nt<E, D>(dp, va, TILE, ring + QT, HALF);             // dP^T_0 = V dO_0^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    for (int n = 0; n + 1 < ntiles; ++n) {
      const float* side = side0 + (n % STAGES) * (SIDE / 4);
      const int q0 = tile_q0(n, side);
      ds_cols(s, dp, side + lrow, side + LROWS * KT, q0, key0, quad, causal && q0 < wg_last,
              scale2);
      wgmma_wait<0>();                                      // tile n-1's dV, dK
      fence_regs(dka);
      fence_regs(dva);
      if (n > 0) release(empty0 + 8 * ((n - 1) % STAGES), lane);
      pack_p<E>(pp, s);
      pack_p<E>(pd, dp);
      const int s1 = (n + 1) % STAGES;
      mbar_wait(full0 + 8 * s1, ((n + 1) / STAGES) & 1);
      const uint32_t qn = ring + 2 * QT * (n % STAGES);
      wgmma_fence();
      issue_nt<E, D>(s, ka, TILE, ring + 2 * QT * s1, HALF);        // S^T_{n+1}
      issue_nt<E, D>(dp, va, TILE, ring + 2 * QT * s1 + QT, HALF);  // dP^T_{n+1}
      wgmma_commit();
      issue_rs<E>(dva, pp, qn + QT, HALF);                      // dV += P^T_n dO_n
      issue_rs<E>(dka, pd, qn, HALF);                           // dK += dS^T_n Q_n
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
    }
    {
      const int n = ntiles - 1;
      const float* side = side0 + (n % STAGES) * (SIDE / 4);
      const int q0 = tile_q0(n, side);
      ds_cols(s, dp, side + lrow, side + LROWS * KT, q0, key0, quad, causal && q0 < wg_last,
              scale2);
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      pack_p<E>(pp, s);
      pack_p<E>(pd, dp);
      const uint32_t qn = ring + 2 * QT * (n % STAGES);
      wgmma_fence();
      issue_rs<E>(dva, pp, qn + QT, HALF);
      issue_rs<E>(dka, pd, qn, HALF);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = ((size_t)kvh * Sk + key) * D;
    auto* dko = reinterpret_cast<typename Elt<E>::E2*>(dk + off);
    auto* dvo = reinterpret_cast<typename Elt<E>::E2*>(dv + off);
#pragma unroll
    for (int h = 0; h < SPANS; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dko[32 * h + 4 * j + quad] = Elt<E>::pack2(dka[h][4 * j + 2 * r] * sm_scale,
                                                   dka[h][4 * j + 2 * r + 1] * sm_scale);
        dvo[32 * h + 4 * j + quad] = Elt<E>::pack2(dva[h][4 * j + 2 * r],
                                                   dva[h][4 * j + 2 * r + 1]);
      }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 3-D map (D, S, BH) of a [BH, S, D] E array, in boxes of 64
// columns (one span, Head) by `rows` rows of one head, swizzled for wgmma.
template <typename E>
bool encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int S, int BH, int rows,
                int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, Elt<E>::TMA, 3, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, bool GATED, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq,
               int Sk, int rep, int causal, float sm_scale, const Gate& gate, void* stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!encode_map<E>(enc, &mq, q, Sq, BH, BM, D) ||
      !encode_map<E>(enc, &mk, k, Sk, BH / rep, BN, D) ||
      !encode_map<E>(enc, &mv, v, Sk, BH / rep, BN, D))
    return (int)cudaErrorInvalidValue;
  // GATED: the stage descriptors after the barriers; blocks (batch, map row)
  const size_t smem = wgmma_fwd_smem<D>() + (GATED ? STAGES * sizeof(StageTile) : 0);
  const int nt = (Sq + BM - 1) / BM;
  const dim3 grid = GATED ? dim3(BH / gate.heads, gate.heads * nt) : dim3(BH, nt);
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_fwd_kernel<E, GATED, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_fwd_kernel<E, GATED, D><<<grid, Head<D>::THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, (E*)o, (float*)lse, Sq, Sk, rep, causal, sm_scale * LOG2E, gate);
  return (int)cudaGetLastError();
}

// Tensor maps of q and dO in boxes of q_rows rows, of k and v in boxes of
// kv_rows rows; false when one does not encode.
template <typename E>
bool encode_bwd_maps(EncodeTiledFn enc, CUtensorMap (&m)[4], const void* q, const void* dout,
                     const void* k, const void* v, int BH, int Sq, int Sk, int rep, int q_rows,
                     int kv_rows, int D) {
  return encode_map<E>(enc, &m[0], q, Sq, BH, q_rows, D) &&
         encode_map<E>(enc, &m[1], dout, Sq, BH, q_rows, D) &&
         encode_map<E>(enc, &m[2], k, Sk, BH / rep, kv_rows, D) &&
         encode_map<E>(enc, &m[3], v, Sk, BH / rep, kv_rows, D);
}

template <typename E, bool GATED, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, int BH, int Sq, int Sk, int rep,
              int causal, float sm_scale, const Gate& gate, void* stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap m[4];
  if (!encode_bwd_maps<E>(enc, m, q, dout, k, v, BH, Sq, Sk, rep, BM, KT, D))
    return (int)cudaErrorInvalidValue;
  // GATED: the stage descriptors after the barriers; blocks (batch, map row)
  const size_t smem = dq_smem<D>() + (GATED ? 8 + STAGES * sizeof(StageTile) : 0);
  const int nt = (Sq + BM - 1) / BM;
  const dim3 grid = GATED ? dim3(BH / gate.heads, gate.heads * nt) : dim3(BH, nt);
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_dq_kernel<E, GATED, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_dq_kernel<E, GATED, D><<<grid, Head<D>::THREADS, smem, (cudaStream_t)stream>>>(
      m[0], m[1], m[2], m[3], (const E*)o, (const E*)dout, (const float*)lse,
      (float*)delta, (E*)dq, Sq, Sk, rep, causal, sm_scale, gate);
  return (int)cudaGetLastError();
}

template <typename E, bool GATED, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BHKV, int Sq, int Sk, int rep,
               int causal, float sm_scale, const Gate& gate, void* stream) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap m[4];
  if (!encode_bwd_maps<E>(enc, m, q, dout, k, v, BHKV * rep, Sq, Sk, rep, KT, BM, D))
    return (int)cudaErrorInvalidValue;
  constexpr size_t DKV_SMEM = dkv_smem<GATED, D>();
  const int nt = (Sk + BM - 1) / BM;   // GATED: blocks (batch, map row)
  const dim3 grid = GATED ? dim3(BHKV / gate.heads, gate.heads * nt) : dim3(BHKV, nt);
  const cudaError_t e = cudaFuncSetAttribute(
      wgmma_dkv_kernel<E, GATED, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  wgmma_dkv_kernel<E, GATED, D><<<grid, DKV_THREADS, DKV_SMEM, (cudaStream_t)stream>>>(
      m[0], m[1], m[2], m[3], (const float*)lse, (const float*)delta, (E*)dk, (E*)dv, Sq,
      Sk, rep, causal, sm_scale, gate);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// ------------------------------------------------------------------ launches
template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, int D, bool GATED>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
               int Sq, int Sk, int rep, int causal, float sm_scale, const Gate& gate,
               void* stream) {
  const size_t smem = fwd_smem<T, D>();
  if (int e = set_smem(fwd_kernel<T, D, GATED>, smem)) return e;
  fwd_kernel<T, D, GATED><<<dim3((Sq + BQ - 1) / BQ, BH), NTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, rep, causal,
      sm_scale * LOG2E, gate);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool GATED>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* delta, void* dq, int BH, int Sq, int Sk, int rep,
              int causal, float sm_scale, const Gate& gate, void* stream) {
  const size_t smem = dq_smem<T, D>();
  if (int e = set_smem(dq_kernel<T, D, GATED>, smem)) return e;
  dq_kernel<T, D, GATED><<<dim3((Sq + BQ - 1) / BQ, BH), NTHREADS, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, (const float*)lse,
      (float*)delta, (T*)dq, Sq, Sk, rep, causal, sm_scale, gate);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool GATED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int BHKV, int Sq,
               int Sk, int rep, int causal, float sm_scale, const Gate& gate, void* stream) {
  const size_t smem = dkv_smem<T, D>();
  if (int e = set_smem(dkv_kernel<T, D, GATED>, smem)) return e;
  dkv_kernel<T, D, GATED><<<dim3((Sk + BK - 1) / BK, BHKV), NTHREADS, smem,
                            (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, Sq, Sk, rep, causal, sm_scale, gate);
  return (int)cudaGetLastError();
}

// The three entry points over both routes and head dims 64 and 128 (the
// layout gate: 64 only), ungated or GATED by `gate`.
template <bool GATED, int D>
int fwd_d(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq, int Sk,
          int rep, int dtype, int causal, float sm_scale, const Gate& gate, void* stream) {
  switch (dtype) {
    case 0: return launch_fwd<float, D, GATED>(q, k, v, o, lse, BH, Sq, Sk, rep, causal,
                                               sm_scale, gate, stream);
    case 1:  // fp16: ungated only (no path runs the fp16 layout gate)
      if constexpr (!GATED)
        return hopper::launch_fwd<__half, false, D>(q, k, v, o, lse, BH, Sq, Sk, rep, causal,
                                                    sm_scale, gate, stream);
      return (int)cudaErrorInvalidValue;
    case 2: return hopper::launch_fwd<bf16, GATED, D>(q, k, v, o, lse, BH, Sq, Sk, rep, causal,
                                                      sm_scale, gate, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool GATED>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int Sq, int Sk,
        int rep, int D, int dtype, int causal, float sm_scale, const Gate& gate, void* stream) {
  if (D == 64)
    return fwd_d<GATED, 64>(q, k, v, o, lse, BH, Sq, Sk, rep, dtype, causal, sm_scale, gate,
                            stream);
  if constexpr (!GATED) {
    if (D == 128)
      return fwd_d<false, 128>(q, k, v, o, lse, BH, Sq, Sk, rep, dtype, causal, sm_scale, gate,
                               stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool GATED, int D>
int bwd_dq_d(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* delta, void* dq, int BH, int Sq, int Sk, int rep, int dtype,
             int causal, float sm_scale, const Gate& gate, void* stream) {
  switch (dtype) {
    case 0: return launch_dq<float, D, GATED>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk, rep,
                                              causal, sm_scale, gate, stream);
    case 1:
      if constexpr (!GATED)
        return hopper::launch_dq<__half, false, D>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk,
                                                   rep, causal, sm_scale, gate, stream);
      return (int)cudaErrorInvalidValue;
    case 2: return hopper::launch_dq<bf16, GATED, D>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk,
                                                     rep, causal, sm_scale, gate, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool GATED>
int bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, int BH, int Sq, int Sk, int rep, int D,
           int dtype, int causal, float sm_scale, const Gate& gate, void* stream) {
  if (D == 64)
    return bwd_dq_d<GATED, 64>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk, rep, dtype, causal,
                               sm_scale, gate, stream);
  if constexpr (!GATED) {
    if (D == 128)
      return bwd_dq_d<false, 128>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk, rep, dtype,
                                  causal, sm_scale, gate, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool GATED, int D>
int bwd_dkv_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int BHKV, int Sq, int Sk, int rep, int dtype,
              int causal, float sm_scale, const Gate& gate, void* stream) {
  switch (dtype) {
    case 0: return launch_dkv<float, D, GATED>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq, Sk,
                                               rep, causal, sm_scale, gate, stream);
    case 1:
      if constexpr (!GATED)
        return hopper::launch_dkv<__half, false, D>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq,
                                                    Sk, rep, causal, sm_scale, gate, stream);
      return (int)cudaErrorInvalidValue;
    case 2: return hopper::launch_dkv<bf16, GATED, D>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq,
                                                      Sk, rep, causal, sm_scale, gate, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool GATED>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int BHKV, int Sq, int Sk, int rep, int D,
            int dtype, int causal, float sm_scale, const Gate& gate, void* stream) {
  if (D == 64)
    return bwd_dkv_d<GATED, 64>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq, Sk, rep, dtype,
                                causal, sm_scale, gate, stream);
  if constexpr (!GATED) {
    if (D == 128)
      return bwd_dkv_d<false, 128>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq, Sk, rep, dtype,
                                   causal, sm_scale, gate, stream);
  }
  return (int)cudaErrorInvalidValue;
}

Gate make_gate(const void* offsets, const void* entries, const void* masks, const void* order,
               int heads, int shift) {
  return Gate{(const int*)offsets, (const int*)entries, (const unsigned long long*)masks,
              (const int*)order, heads, shift};
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  D: 64 (GPT-2) or 128 (Llama),
// the _layout entry points 64 only (and not float16).  Each entry point
// picks its kernel by dtype: bf16 and fp16 the wgmma + TMA kernel
// instantiated for the type, float32 the plain-f32 tile kernel.  Unsupported
// (dtype, D) pairs return cudaErrorInvalidValue; the Python wrappers check
// them first.  There is no fallback: a tensor map that does not encode or a
// launch that fails returns its error.  The _layout entry points take the
// tile map of ops/flash_attention.py::layout_tile_map for the kernel's
// tiles (bf16: forward 128 x 128, dq 128 queries x 64 keys, dkv 64 x 128;
// f32: 64 x 64), its head count (query heads; dkv: KV heads) and log2 of
// the layout's block.
extern "C" {

int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int BH, int Sq, int Sk, int rep, int D, int dtype, int causal,
                           float sm_scale, void* stream) {
  return fwd<false>(q, k, v, o, lse, BH, Sq, Sk, rep, D, dtype, causal, sm_scale, Gate{},
                    stream);
}

// o may be null: delta is then read; otherwise delta is computed and written.
int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* delta, void* dq,
                              int BH, int Sq, int Sk, int rep, int D, int dtype, int causal,
                              float sm_scale, void* stream) {
  return bwd_dq<false>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk, rep, D, dtype, causal,
                       sm_scale, Gate{}, stream);
}

int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dk, void* dv,
                               int BHKV, int Sq, int Sk, int rep, int D, int dtype,
                               int causal, float sm_scale, void* stream) {
  return bwd_dkv<false>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq, Sk, rep, D, dtype, causal,
                        sm_scale, Gate{}, stream);
}

int ds_flash_attention_fwd_layout(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int BH, int Sq, int Sk, int rep, int D, int dtype,
                                  int causal, float sm_scale, const void* offsets,
                                  const void* entries, const void* masks, const void* order,
                                  int heads, int shift, void* stream) {
  return fwd<true>(q, k, v, o, lse, BH, Sq, Sk, rep, D, dtype, causal, sm_scale,
                   make_gate(offsets, entries, masks, order, heads, shift), stream);
}

int ds_flash_attention_bwd_dq_layout(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     int BH, int Sq, int Sk, int rep, int D, int dtype,
                                     int causal, float sm_scale, const void* offsets,
                                     const void* entries, const void* masks, const void* order,
                                     int heads, int shift, void* stream) {
  return bwd_dq<true>(q, k, v, o, dout, lse, delta, dq, BH, Sq, Sk, rep, D, dtype, causal,
                      sm_scale, make_gate(offsets, entries, masks, order, heads, shift), stream);
}

int ds_flash_attention_bwd_dkv_layout(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv, int BHKV, int Sq, int Sk, int rep,
                                      int D, int dtype, int causal, float sm_scale,
                                      const void* offsets, const void* entries,
                                      const void* masks, const void* order, int heads,
                                      int shift, void* stream) {
  return bwd_dkv<true>(q, k, v, dout, lse, delta, dk, dv, BHKV, Sq, Sk, rep, D, dtype, causal,
                       sm_scale, make_gate(offsets, entries, masks, order, heads, shift), stream);
}

}  // extern "C"
