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
//   ds_quantized_matmul     <- _qmm_call (_kernel): x [M >= 1, K] float, q
//                              int8 [K, N], scale f32 [K, N/G], K % 8 == 0,
//                              G % 128 == 0
// Every one returns cudaGetLastError() after its launch.
//
// w8a8 arithmetic (quantized_matmul.py:249-263, kept literally): for each
// k-group g of G rows, each row's ax = max|x| in f32 (0 read as 1), codes
// xq = clip(rint(x * (127 / ax)), -127, 127), the exact int32 dot of the
// codes with the int8 weight column, and t_g = (float(dot) * (ax / 127)) *
// kscale[g, n] in f32; the output is ((t_0 + t_1) + ...) + t_{G-1}, summed in
// group order in f32 and cast once.  The multiplies and adds are the _rn
// intrinsics so nvcc cannot contract them into FMAs, and rintf rounds half
// to even as jnp.round does.  So the result is the plain version's bits,
// and a row's result depends on no other row, whatever B is.
//
// w8a8_split_kernel (B5, B6).  Bound: the weight bytes, K*N int8 plus K/G*N
// f32 scales, over 3.35 TB/s (0.55 us at GPT-2's (768, 2304)); 2*B*K*N
// int8 operations are far below the tensor cores' rate at B <= 8.  At
// these sizes what decides the time is how many SMs have weight bytes in
// flight at once and how many dependent steps a block takes.  So each
// 64-column tile gets a thread-block cluster of C <= 16 blocks that split
// its k-groups, gpb = K/G/C each (the fewest that divide K/G): 216 blocks
// of one group at (768, 2304), 288 at (768, 3072), 72 at (768, 768), 144
// of two groups at (3072, 768); at llama-3-8b's w2 (14336, 4096), 112
// groups, 1024 blocks of 7, and at llama-3-70b's (28672, 8192), 224
// groups, 2048 blocks of 14.  A block of several groups is two
// sub-blocks of 128 threads, each on its own group, so its two groups
// take the time of one.  A sub-block's 4 warps issue their weight loads
// first, 16 words a thread a pass of 128 k-rows straight into registers
// (32 k-rows of 64 columns a warp; each 32-byte sector read whole), then
// load and quantize their group's x (the only activations they read) into
// shared memory; a group of more than one pass loads the next pass's
// words while the current one multiplies.  The dot runs on the int8
// tensor cores: mma.sync m16n8k32 s8 with the weight columns as M = 16 and
// the <= 8 activation rows as N = 8, so a decode batch fills the
// instruction.  The codes sit [row][k] in shared memory,
// which is the B fragment's layout (one 32-bit load a register).  The A
// fragment wants 4 consecutive k of one column while qk [K, N] keeps N
// contiguous: m-tile mt's row m is column 4m + mt, so the 4 words a thread
// loads for one register (4 k-rows of 4 adjacent columns) become that
// register of the 4 m tiles by a 4 x 4 byte transpose (__byte_perm).  The
// records keep the JAX package's layout.  int32 sums of 128 products of
// |127| are exact, so the dot is the integer of the plain version.  The 4
// warps' dots are summed in shared memory (exact), and each group's term
// t_g stays in the shared memory of the block that computed it (terms
// [gpb][8][64] f32, 2 KB a group: gpb <= 104 fits); after a cluster barrier
// block 0 reads the terms in group order, group g from rank g / gpb through
// distributed shared memory, sums them and writes the output, and a second
// barrier keeps every block's terms alive until then.  So the number of
// groups is bounded by 16 blocks of 104, not by one block's shared memory
// (as when every term went into block 0's: 104 groups), and the sum order
// is the same group order as that design's, so its outputs are the same
// bits.  One launch, no scratch in device memory, no second pass: a merge
// through device memory (scratch, a fence, an atomic ticket, a re-read)
// costs three dependent trips to L2 where this costs a cluster barrier.  B6 reads the layer
// index once a block and clamps it to [0, L).  G is any divisor of K: a
// group is taken in passes of 128 k-rows and rows past its end read as
// zero codes and zero weights.

// Weight-only arithmetic (quantized_matmul.py:91-98): out = sum_k bf16(x) *
// bf16(bf16(q) * bf16(scale[k, n/G])) with f32 accumulation, cast once; the
// weight's product rounds to bf16 as the TPU kernel's bf16 multiply does
// (the f32 product of an int8 and a bf16 is exact, so one rounding).
//
// qmm_split_kernel (B7).  Bound: the weight bytes, K*N int8 plus K*N/G f32
// scales, over 3.35 TB/s (0.55 us at GPT-2's (768, 2304)); the 2*M*K*N bf16
// products are far below the tensor cores' rate at decode sizes.  As for
// w8a8, what decides the time is how many SMs have weight bytes in flight
// and how many dependent steps a block takes.  K is cut into 128-row
// chunks; each 64-column tile gets a thread-block cluster of C <= 16
// blocks, block y on chunks [y*cpb, (y+1)*cpb), cpb the fewest that leave
// at most 16 blocks (216 blocks of one chunk at (768, 2304), 72 at (768,
// 768), 288 at (768, 3072), 144 of two at (3072, 768)).  A block's 4 warps
// take 32 k-rows of each chunk; a thread loads its 8 columns of 8 k-rows
// of the chunk as 8-byte words straight into registers (each warp load
// reads 4 whole 64-byte row segments), and the next chunk's words, scales
// and activations are in flight while the current chunk multiplies.  The
// weight tile is dequantized in registers (int8 -> f32 exactly, times the
// bf16-rounded scale, rounded once to bf16) into the A fragment of bf16
// mma.sync m16n8k16 with f32 accumulation: the weight columns are the
// mma's M (m-tile mt's rows g and g + 8 are columns 8g + 2mt and 8g + 2mt
// + 1, so a thread's 8 columns are one 8-byte word), the activation rows
// its N, so a decode batch fills the instruction; the activations sit
// [row][k] as bf16 in shared memory, the B fragment's layout.  A 64-column
// tile lies inside one scale group (64 | G): a chunk needs one scale per
// k-row, staged once in shared memory.  The sum order is a function of
// (K, N, G) alone: each warp accumulates its k-slices of the block's
// chunks in chunk order, the 4 warps' partials are summed in warp order
// into the block's term, and after a cluster barrier each output is the
// cluster's terms summed in rank order, read from the blocks' shared
// memory (the merge is spread over the blocks; a second barrier keeps
// every term alive until read).  Rows only choose how many 8-row n-tiles a block takes (1, 2 or
// 4) and how many row tiles the grid has (its z), never the split of K, so
// a row's result is the same bits in a call of any row count.  Rows past M
// read zero activations and are not written; k-rows past K read zero
// weights and activations (K % 8 == 0; K % 16 == 8 leaves half a k-step
// of zeros).  One launch, no scratch in device memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

constexpr int W8_THREADS = 128;                  // 4 warps
constexpr int W8_ROWS = 8;                       // W8A8_MAX_ROWS: the mma's N
constexpr int W8_TN = 64;                        // output columns per block
constexpr int W8_KC = 128;                       // k-rows a pass, 32 a warp
constexpr int W8_XQ = W8_KC + 16;                // code row stride (bytes)
constexpr int W8_CLUSTER = 16;                   // blocks of a column tile
// k-groups a block may take: their terms fill its dynamic shared memory,
// 2 KB each (so a call takes up to 16 x 104 groups, as they divide)
constexpr int W8_MAX_GPB = 104;
constexpr size_t W8_MAX_SMEM = (size_t)W8_MAX_GPB * W8_ROWS * W8_TN * 4;

// c[16 x 8] (s32) += a[16 x 32] * b[32 x 8] (s8), fragments as mma.sync lays
// them out, lane = 4 * grp + tig: a[0] row grp at k 4*tig..+3 (the low byte
// the lowest k), a[1] row grp + 8 at the same k, a[2] and a[3] the same
// rows at k 16 + 4*tig..+3; b[0] column grp at k 4*tig..+3, b[1] at k
// 16 + 4*tig..+3; c[i] row grp + 8 * (i >> 1), column 2 * tig + (i & 1).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 4 x 4 byte transpose: byte c of w[j] becomes byte j of o[c].
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// A thread's weight words of one pass: the warp's 32 k-rows from k-row kw
// of the group (qg points at the group's first row, at the thread's first
// column), as the A operand wants them.  m-tile mt's row m is column
// 4m + mt of the block's 64, so the 4 words loaded for one register (k-rows
// k..k+3 of 4 adjacent columns, at columns 4*grp.. or 32 + 4*grp..) become
// that register of all 4 m tiles by transpose4.  Rows past the group read
// as 0.
__device__ __forceinline__ void load_pass(uint32_t (&w)[4][4],
                                          const int8_t* qg, int kw, int G,
                                          int N) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = kw + j + (r >> 1) * 16;
      w[r][j] = kk < G ? __ldg(reinterpret_cast<const unsigned*>(
                             qg + (size_t)kk * N + (r & 1) * 32))
                       : 0u;
    }
}

// One cluster of blocks per 64-column tile, spanning K: grid (N / 64, C)
// with cluster dims (1, C, 1), C = K / G / gpb <= 16 blocks, block y taking
// k-groups [y * gpb, (y + 1) * gpb), P at a time: the block is P sub-blocks
// of 128 threads, sub-block s on group gc + s of each step gc.  Each
// group's term stays in the block's shared memory (terms [gpb][8 rows][16
// column quads], dynamic); after a cluster barrier the cluster's block 0
// reads them all in group order, sums them and writes the output.
template <typename TX, typename TO, int P>
__global__ void __launch_bounds__(W8_THREADS * P)
w8a8_split_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qk,
                  const float* __restrict__ kscale,
                  const int* __restrict__ layer, TO* __restrict__ out, int L,
                  int B, int K, int N, int G, int gpb) {
  __shared__ __align__(16) int red[P][4][W8_ROWS][W8_TN];   // warps' dots
  __shared__ __align__(16) int8_t xq[P][W8_ROWS][W8_XQ];    // codes [row][k]
  extern __shared__ float4 terms[];

  cg::cluster_group cluster = cg::this_cluster();
  const int sub = threadIdx.x / W8_THREADS, tid = threadIdx.x % W8_THREADS;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * W8_TN, g0 = blockIdx.y * gpb;
  // the thread's activation row; its 8 k of each pass (quantization) and
  // its 4 output columns (epilogue)
  const int row = tid >> 4, k8 = (tid & 15) * 8, quad = tid & 15;
  if (layer != nullptr) {
    const int l = min(max(__ldg(layer), 0), L - 1);
    qk += (size_t)l * K * N;
    kscale += (size_t)l * (K / G) * N;
  }
  const int kw = 32 * warp + 4 * tig;
  const TX* xrow = x + (size_t)min(row, B - 1) * K;

  for (int gc = 0; gc < gpb; gc += P) {
    const bool live = gc + sub < gpb;
    const int g = g0 + gc + sub;
    const int8_t* qg = qk + (size_t)g * G * N + n0 + 4 * grp;
    const TX* xg = xrow + (size_t)g * G;
    // The first pass's weights go in flight first, the bytes that bound
    // the kernel; then the group's scales and first activations
    uint32_t w[4][4] = {};                       // [register][k row]
    if (live) load_pass(w, qg, kw, G, N);
    float4 ks = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      ks = __ldg(reinterpret_cast<const float4*>(kscale + (size_t)g * N + n0 +
                                                 4 * quad));
    float xv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      xv[j] = live && row < B && k8 + j < G ? Cvt<TX>::in(xg[k8 + j]) : 0.f;

    // ax = max |x| over the row's group: the thread's values, then the 16
    // threads of the row (an exact max, so its order is free)
    float ax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ax = fmaxf(ax, fabsf(xv[j]));
    if (live && row < B)
      for (int k = k8 + W8_KC; k < G; k += W8_KC)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k + j < G) ax = fmaxf(ax, fabsf(Cvt<TX>::in(xg[k + j])));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, o));
    if (ax == 0.f) ax = 1.f;
    const float inv = __fdiv_rn(127.f, ax);

    int acc[4][4] = {};                          // [m tile][fragment]
    for (int c0 = 0; c0 < G; c0 += W8_KC) {
      if (c0 > 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xv[j] = live && row < B && c0 + k8 + j < G
                      ? Cvt<TX>::in(xg[c0 + k8 + j]) : 0.f;
      uint32_t cw[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float qv = rintf(__fmul_rn(xv[j], inv));
        qv = fminf(fmaxf(qv, -127.f), 127.f);
        cw[j >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)qv << (8 * (j & 3));
      }
      *reinterpret_cast<uint2*>(&xq[sub][row][k8]) = make_uint2(cw[0], cw[1]);
      __syncthreads();
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
          &xq[sub][grp][32 * warp + 4 * tig]);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
          &xq[sub][grp][32 * warp + 16 + 4 * tig]);
      uint32_t a[4][4];                          // [m tile][register]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t o[4];
        transpose4(w[r], o);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) a[mt][r] = o[mt];
      }
      // a group longer than one pass loads the next while this multiplies
      if (live && c0 + W8_KC < G) load_pass(w, qg, c0 + W8_KC + kw, G, N);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt], a[mt], b0, b1);
      __syncthreads();                           // xq is rewritten
    }

    // the 4 warps' dots of (row, column) summed in shared memory (exact),
    // then the group's term into block 0
#pragma unroll
    for (int f = 0; f < 4; ++f)
      *reinterpret_cast<int4*>(
          &red[sub][warp][2 * tig + (f & 1)][(f >> 1) * 32 + 4 * grp]) =
          make_int4(acc[0][f], acc[1][f], acc[2][f], acc[3][f]);
    __syncthreads();
    int dot[4] = {0, 0, 0, 0};
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      const int4 v = *reinterpret_cast<const int4*>(&red[sub][wi][row][4 * quad]);
      dot[0] += v.x; dot[1] += v.y; dot[2] += v.z; dot[3] += v.w;
    }
    const float s = __fdiv_rn(ax, 127.f);
    if (live)
      terms[((gc + sub) * W8_ROWS + row) * (W8_TN / 4) + quad] = make_float4(
          __fmul_rn(__fmul_rn((float)dot[0], s), ks.x),
          __fmul_rn(__fmul_rn((float)dot[1], s), ks.y),
          __fmul_rn(__fmul_rn((float)dot[2], s), ks.z),
          __fmul_rn(__fmul_rn((float)dot[3], s), ks.w));
  }

  // block 0 sums the terms in group order once every block's are in,
  // group gi from rank gi / gpb's shared memory
  cluster.sync();
  if (cluster.block_rank() == 0 && sub == 0 && row < B) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < (int)gridDim.y; ++r) {
      const float4* src = cluster.map_shared_rank(terms, r) + row * (W8_TN / 4) + quad;
#pragma unroll 4
      for (int lg = 0; lg < gpb; ++lg) {
        const float4 v = src[lg * W8_ROWS * (W8_TN / 4)];
        sum[0] = __fadd_rn(sum[0], v.x);
        sum[1] = __fadd_rn(sum[1], v.y);
        sum[2] = __fadd_rn(sum[2], v.z);
        sum[3] = __fadd_rn(sum[3], v.w);
      }
    }
    TO* orow = out + (size_t)row * N + n0 + 4 * quad;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[j] = Cvt<TO>::out(sum[j]);
  }
  cluster.sync();                                // terms read: blocks may end
}

constexpr int QM_THREADS = 128;                  // 4 warps
constexpr int QM_TN = 64;                        // output columns per block
constexpr int QM_KC = 128;                       // k-rows a chunk, 32 a warp
constexpr int QM_CLUSTER = 16;                   // blocks of a column tile
constexpr int QM_XS = QM_KC + 8;                 // activation row stride (bf16)
constexpr int QM_RS = QM_TN + 4;                 // partial row stride (f32)

// c[16 x 8] (f32) += a[16 x 16] * b[16 x 8] (bf16), lane = 4 * grp + tig:
// a[0] row grp at k 2*tig, 2*tig+1 (the low half the lower k), a[1] row
// grp + 8 at the same k, a[2] and a[3] the same rows at k + 8; b[0] column
// grp at k 2*tig, 2*tig+1, b[1] at k + 8; c[i] row grp + 8 * (i >> 1),
// column 2 * tig + (i & 1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 consecutive activations of type TX, loaded as sizeof(TX) / 2 16-byte
// words, rounded to bf16 and packed in k order
template <typename TX>
__device__ __forceinline__ uint4 qm_x_bf16(const uint4 (&r)[sizeof(TX) / 2]) {
  if constexpr (std::is_same<TX, float>::value) {
    return make_uint4(
        bf16x2_bits(__uint_as_float(r[0].x), __uint_as_float(r[0].y)),
        bf16x2_bits(__uint_as_float(r[0].z), __uint_as_float(r[0].w)),
        bf16x2_bits(__uint_as_float(r[1].x), __uint_as_float(r[1].y)),
        bf16x2_bits(__uint_as_float(r[1].z), __uint_as_float(r[1].w)));
  } else if constexpr (std::is_same<TX, __half>::value) {
    const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = bf16x2_bits(
          __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu))),
          __half2float(__ushort_as_half((unsigned short)(w[i] >> 16))));
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    return r[0];
  }
}

// bf16(bf16(q) * s) for byte `b` of a thread's 8-column word (s already
// rounded to bf16): the f32 product is exact, so it rounds once
__device__ __forceinline__ float qm_deq(uint2 w, int b, float s) {
  const uint32_t v = b < 4 ? w.x : w.y;
  return __fmul_rn((float)(int8_t)(v >> (8 * (b & 3))), s);
}

// One cluster of blocks per 64-column tile, spanning K: grid (N / 64, C,
// row tiles) with cluster dims (1, C, 1), block y on k-chunks [y * cpb,
// min((y + 1) * cpb, chunks)), and NT 8-row n-tiles of rows [z * 8 * NT,
// ...).  Warp w takes k-rows 32w..32w+31 of each chunk, in 2 k-steps of
// 16; a thread (grp, tig) loads k-rows 2tig, 2tig+1, 2tig+8, 2tig+9 of each
// step at columns 8grp..8grp+7, which are its A fragments' rows of all 4
// m tiles.  Each block's term (the 4 warps' partials summed in warp order)
// stays in its own shared memory; after a cluster barrier the outputs are
// shared out over the blocks, each summing the C terms in rank order.
template <typename TX, typename TO, int NT>
__global__ void __launch_bounds__(QM_THREADS)
qmm_split_kernel(const TX* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, TO* __restrict__ out,
                 int M, int K, int N, int G, int cpb) {
  constexpr int R = 8 * NT;                      // rows of a block
  constexpr int XW = sizeof(TX) / 2;             // 16-byte words of 8 x
  __shared__ __align__(16) float part[4][R][QM_RS];         // warps' sums
  __shared__ __align__(16) __nv_bfloat16 xs[R][QM_XS];      // [row][k]
  __shared__ __align__(16) float ss[QM_KC];                 // bf16 scales

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * QM_TN, m0 = blockIdx.z * R;
  const int chunks = (K + QM_KC - 1) / QM_KC;
  const int c0 = blockIdx.y * cpb, c1 = min(c0 + cpb, chunks);
  const int ng = N / G, sg = n0 / G;
  // the thread's weight column word and its activations: 8 k from k8 of
  // rows xr + 8i
  const int8_t* qcol = q + n0 + 8 * grp;
  const int xr = tid >> 4, k8 = (tid & 15) * 8;

  uint2 w[2][4];                                 // [k step][k row]
  uint4 xraw[NT][XW];
  float sraw;
  // chunk c's loads: the weight words first, the bytes that bound the
  // kernel, then the scale and the activations
  auto load_chunk = [&](int c) {
    const int kw = c * QM_KC + 32 * warp + 2 * tig;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = kw + 16 * j + (r >> 1) * 8 + (r & 1);
        w[j][r] = k < K ? __ldg(reinterpret_cast<const uint2*>(
                              qcol + (size_t)k * N))
                        : make_uint2(0u, 0u);
      }
    const int ks = c * QM_KC + tid;
    sraw = ks < K ? __ldg(scale + (size_t)ks * ng + sg) : 0.f;
    const int kx = c * QM_KC + k8;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int m = m0 + xr + 8 * i;
      const bool live = m < M && kx < K;
      const uint4* src =
          reinterpret_cast<const uint4*>(x + (size_t)m * K + kx);
#pragma unroll
      for (int v = 0; v < XW; ++v)
        xraw[i][v] = live ? __ldg(src + v) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[NT][4][4] = {};                      // [n tile][m tile][frag]
  load_chunk(c0);
  for (int c = c0; c < c1; ++c) {
    if (c > c0) __syncthreads();                 // the last chunk's reads
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<uint4*>(&xs[xr + 8 * i][k8]) =
          qm_x_bf16<TX>(xraw[i]);
    ss[tid] = __bfloat162float(__float2bfloat16_rn(sraw));
    __syncthreads();
    uint2 wc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) wc[j][r] = w[j][r];
    // the next chunk's loads go in flight while this one multiplies
    if (c + 1 < c1) load_chunk(c + 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = 32 * warp + 16 * j + 2 * tig;
      const float2 s01 = *reinterpret_cast<const float2*>(&ss[kk]);
      const float2 s89 = *reinterpret_cast<const float2*>(&ss[kk + 8]);
      uint32_t a[4][4];                          // [m tile][register]
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = 2 * mt + h;
          a[mt][h] = bf16x2_bits(qm_deq(wc[j][0], b, s01.x),
                                 qm_deq(wc[j][1], b, s01.y));
          a[mt][2 + h] = bf16x2_bits(qm_deq(wc[j][2], b, s89.x),
                                     qm_deq(wc[j][3], b, s89.y));
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
            &xs[8 * nt + grp][kk]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &xs[8 * nt + grp][kk + 8]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[nt][mt], a[mt], b0, b1);
      }
    }
  }

  // c[mt][2h + e] is column 8grp + 2mt + h of row 8nt + 2tig + e
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* p = &part[warp][8 * nt + 2 * tig + e][8 * grp];
      const float(&c)[4][4] = acc[nt];
      *reinterpret_cast<float4*>(p) =
          make_float4(c[0][e], c[0][2 + e], c[1][e], c[1][2 + e]);
      *reinterpret_cast<float4*>(p + 4) =
          make_float4(c[2][e], c[2][2 + e], c[3][e], c[3][2 + e]);
    }
  __syncthreads();
  // the block's term: the warps' partials in warp order, into part[0]
  for (int e = tid; e < R * (QM_TN / 4); e += QM_THREADS) {
    float4* t = reinterpret_cast<float4*>(&part[0][e >> 4][(e & 15) * 4]);
    float4 v = *t;
#pragma unroll
    for (int wi = 1; wi < 4; ++wi) {
      const float4 u = *reinterpret_cast<const float4*>(
          &part[wi][e >> 4][(e & 15) * 4]);
      v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y),
                      __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
    }
    *t = v;
  }
  cluster.sync();
  // each output 4-column quad: the cluster's terms summed in rank order
  const int rank = (int)cluster.block_rank(), blocks = (int)gridDim.y;
  for (int e = rank * QM_THREADS + tid; e < R * (QM_TN / 4);
       e += blocks * QM_THREADS) {
    const int row = e >> 4, col = (e & 15) * 4;
    if (m0 + row >= M) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = 0; r < blocks; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(&part[0][row][col], r));
      sum[0] = __fadd_rn(sum[0], t.x);
      sum[1] = __fadd_rn(sum[1], t.y);
      sum[2] = __fadd_rn(sum[2], t.z);
      sum[3] = __fadd_rn(sum[3], t.w);
    }
    TO* o = out + (size_t)(m0 + row) * N + n0 + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = Cvt<TO>::out(sum[j]);
  }
  cluster.sync();                                // terms read: blocks may end
}
// Set once per kernel: the dynamic shared memory it may take (0: the
// default) and clusters of more than 8 blocks.
template <typename... A>
cudaError_t allow_clusters(void (*kernel)(A...), size_t max_smem) {
  cudaError_t e = cudaSuccess;
  if (max_smem)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// `kernel` on `grid` in clusters of (1, grid.y, 1) blocks, after its
// allow_clusters `setup`; returns the launch's error.
template <typename... A, typename... Args>
int launch_cluster(void (*kernel)(A...), cudaError_t setup, dim3 grid,
                   int threads, size_t smem, void* stream, Args... args) {
  if (setup != cudaSuccess) return (int)setup;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// k-groups a block of the w8a8 kernel takes: the fewest that divide K / G
// and leave at most W8_CLUSTER blocks, one cluster, a column tile; 0 when
// that is more than W8_MAX_GPB (a prime count past 104, or past 16 x 104).
int w8a8_groups_per_block(int groups) {
  if (groups < 1) return 0;
  int gpb = (groups + W8_CLUSTER - 1) / W8_CLUSTER;
  while (groups % gpb) ++gpb;
  return gpb <= W8_MAX_GPB ? gpb : 0;
}

template <typename TX, typename TO, int P>
int launch_w8a8_p(const void* layer, const void* x, const void* qk,
                  const void* kscale, void* out, int L, int B, int K, int N,
                  int G, int gpb, void* stream) {
  auto kernel = w8a8_split_kernel<TX, TO, P>;
  static const cudaError_t setup = allow_clusters(kernel, W8_MAX_SMEM);
  const int groups = K / G, blocks = groups / gpb;
  return launch_cluster(kernel, setup, dim3(N / W8_TN, blocks),
                        W8_THREADS * P,
                        (size_t)gpb * W8_ROWS * W8_TN * sizeof(float),
                        stream, (const TX*)x, (const int8_t*)qk,
                        (const float*)kscale, (const int*)layer, (TO*)out, L,
                        B, K, N, G, gpb);
}

// A block of one k-group is one sub-block; a block of more takes two
// groups at a time.
template <typename TX, typename TO>
int launch_w8a8(const void* layer, const void* x, const void* qk,
                const void* kscale, void* out, int L, int B, int K, int N,
                int G, void* stream) {
  const int gpb = G < 1 || K % G ? 0 : w8a8_groups_per_block(K / G);
  if (B < 1 || B > W8_ROWS || gpb == 0 || N % W8_TN)
    return (int)cudaErrorInvalidValue;
  if (gpb == 1)
    return launch_w8a8_p<TX, TO, 1>(layer, x, qk, kscale, out, L, B, K, N, G,
                                    gpb, stream);
  return launch_w8a8_p<TX, TO, 2>(layer, x, qk, kscale, out, L, B, K, N, G,
                                  gpb, stream);
}

// k-chunks a block of the weight-only kernel takes: the fewest that leave
// at most QM_CLUSTER blocks, one cluster, a column tile; 0 for a shape the
// kernel does not take (K % 8, G % 128, N % G).  No row count enters, so
// the sum order is the same in calls of any row count.
int qmm_chunks_per_block(int K, int N, int G) {
  if (K < 8 || K % 8 || G < 128 || G % 128 || N % G) return 0;
  const int chunks = (K + QM_KC - 1) / QM_KC;
  return (chunks + QM_CLUSTER - 1) / QM_CLUSTER;
}

template <typename TX, typename TO, int NT>
int launch_qmm_nt(const void* x, const void* q, const void* scale, void* out,
                  int M, int K, int N, int G, int cpb, void* stream) {
  auto kernel = qmm_split_kernel<TX, TO, NT>;
  static const cudaError_t setup = allow_clusters(kernel, 0);
  const int chunks = (K + QM_KC - 1) / QM_KC, blocks = (chunks + cpb - 1) / cpb;
  return launch_cluster(kernel, setup,
                        dim3(N / QM_TN, blocks, (M + 8 * NT - 1) / (8 * NT)),
                        QM_THREADS, 0, stream, (const TX*)x, (const int8_t*)q,
                        (const float*)scale, (TO*)out, M, K, N, G, cpb);
}

// A block takes 8 rows (one n-tile) up to 8, then 16, then 32 rows and as
// many row tiles as the call needs.
template <typename TX, typename TO>
int launch_qmm(const void* x, const void* q, const void* scale, void* out,
               int M, int K, int N, int G, void* stream) {
  const int cpb = qmm_chunks_per_block(K, N, G);
  if (M < 1 || cpb == 0) return (int)cudaErrorInvalidValue;
  if (M <= 8)
    return launch_qmm_nt<TX, TO, 1>(x, q, scale, out, M, K, N, G, cpb, stream);
  if (M <= 16)
    return launch_qmm_nt<TX, TO, 2>(x, q, scale, out, M, K, N, G, cpb, stream);
  return launch_qmm_nt<TX, TO, 4>(x, q, scale, out, M, K, N, G, cpb, stream);
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
