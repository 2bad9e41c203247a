// Host-side optimizers (OpenMP) for ZeRO-Offload stepping of the optimizer
// state that lives in host memory.
//
// The port's copy of deepspeed_tpu/ops/csrc/cpu_adam.cpp (itself the
// counterpart of the reference's csrc/adam/cpu_adam.cpp and
// csrc/adagrad/cpu_adagrad.cpp).  The update arithmetic is the JAX
// package's, expression for expression and in the same order, and the
// library is built with the same g++ flags (ops/op_builder.py HOST_FLAGS),
// so the two libraries compile the loops alike and compute the same bits:
// g++ contracts a*b+c into FMAs in C++ even under -std=c++17, in both (the
// plain versions in ops/cpu_adam.py follow those roundings).
//   - adamw_mode=1: decoupled weight decay (param -= lr*wd*param)
//   - adamw_mode=0: classic L2 (grad += wd*param before the moments)
//   - bias_correction toggles the 1/(1-beta^t) terms
//
// Added in the port:
//   - ds_adam_step_bf16 / ds_adagrad_step_bf16: the same update, also
//     writing each updated weight as bf16 (round to nearest even, as
//     torch's Tensor.to(torch.bfloat16) rounds) in the same pass, so the
//     offload engine sends the card half the bytes of the f32 masters;
//   - ds_add: the streamed blocks' host gradient accumulation;
//   - ds_set_num_threads / ds_get_num_threads: the OpenMP pool size, so
//     that several processes on one host do not each start a pool of every
//     core.
// The elementwise entries give the same bits at any thread count;
// ds_sq_norm's sum depends on it.
//
// These are host functions: no TPU kernel corresponds to them.  They are
// bound by memory bandwidth (Adam reads p, g, m, v and writes p, m, v, and
// the bf16 copy: 30 bytes an element with it).  Under these flags the Adam
// and Adagrad loops stay scalar (std::sqrt keeps errno), at 29-40% of the
// host's copy rate (PERF.md section 6).
//
// C ABI so Python binds via ctypes.

#include <omp.h>

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// float -> bf16 bits, round to nearest even; NaN -> 0x7FC0 (c10::BFloat16).
inline uint16_t to_bf16(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof(u));
  if (std::isnan(x)) return UINT16_C(0x7FC0);
  uint32_t bias = ((u >> 16) & 1u) + UINT32_C(0x7FFF);
  return static_cast<uint16_t>((u + bias) >> 16);
}

template <bool kBf16>
void adam_step(float* p, const float* g, float* m, float* v, int64_t n,
               float lr, float beta1, float beta2, float eps, float wd,
               int64_t step, int bias_correction, int adamw_mode,
               uint16_t* out16) {
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, (float)step);
    bc2 = 1.0f - std::pow(beta2, (float)step);
  }
  const float step_size = lr / bc1;
  const float bc2_sqrt = std::sqrt(bc2);
  const float decay = (adamw_mode && wd > 0.0f) ? (1.0f - lr * wd) : 1.0f;

#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (!adamw_mode && wd > 0.0f) grad += wd * p[i];
    float mi = beta1 * m[i] + (1.0f - beta1) * grad;
    float vi = beta2 * v[i] + (1.0f - beta2) * grad * grad;
    m[i] = mi;
    v[i] = vi;
    float denom = std::sqrt(vi) / bc2_sqrt + eps;
    float pi = decay * p[i] - step_size * (mi / denom);
    p[i] = pi;
    if constexpr (kBf16) out16[i] = to_bf16(pi);
  }
}

template <bool kBf16>
void adagrad_step(float* p, const float* g, float* s, int64_t n, float lr,
                  float eps, float wd, uint16_t* out16) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i] + wd * p[i];
    float si = s[i] + grad * grad;
    s[i] = si;
    float pi = p[i] - lr * grad / (std::sqrt(si) + eps);
    p[i] = pi;
    if constexpr (kBf16) out16[i] = to_bf16(pi);
  }
}

}  // namespace

extern "C" {

void ds_adam_step(float* p, const float* g, float* m, float* v, int64_t n,
                  float lr, float beta1, float beta2, float eps, float wd,
                  int64_t step, int bias_correction, int adamw_mode) {
  adam_step<false>(p, g, m, v, n, lr, beta1, beta2, eps, wd, step,
                   bias_correction, adamw_mode, nullptr);
}

void ds_adam_step_bf16(float* p, const float* g, float* m, float* v,
                       int64_t n, float lr, float beta1, float beta2,
                       float eps, float wd, int64_t step, int bias_correction,
                       int adamw_mode, uint16_t* out16) {
  adam_step<true>(p, g, m, v, n, lr, beta1, beta2, eps, wd, step,
                  bias_correction, adamw_mode, out16);
}

void ds_adagrad_step(float* p, const float* g, float* s, int64_t n, float lr,
                     float eps, float wd) {
  adagrad_step<false>(p, g, s, n, lr, eps, wd, nullptr);
}

void ds_adagrad_step_bf16(float* p, const float* g, float* s, int64_t n,
                          float lr, float eps, float wd, uint16_t* out16) {
  adagrad_step<true>(p, g, s, n, lr, eps, wd, out16);
}

// Squared L2 norm of a buffer (for host-side global grad-norm clipping).
double ds_sq_norm(const float* x, int64_t n) {
  double acc = 0.0;
#pragma omp parallel for simd reduction(+ : acc) schedule(static)
  for (int64_t i = 0; i < n; ++i) acc += (double)x[i] * (double)x[i];
  return acc;
}

// In-place scale (applies the clip coefficient).
void ds_scale(float* x, int64_t n, float scale) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) x[i] *= scale;
}

// 1 if every element is finite (host-side overflow check for fp16 paths).
int ds_all_finite(const float* x, int64_t n) {
  int ok = 1;
#pragma omp parallel for simd reduction(&& : ok) schedule(static)
  for (int64_t i = 0; i < n; ++i) ok = ok && std::isfinite(x[i]);
  return ok;
}

// acc[i] += x[i] (a host gradient accumulator).
void ds_add(float* acc, const float* x, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) acc[i] += x[i];
}

void ds_set_num_threads(int n) { omp_set_num_threads(n < 1 ? 1 : n); }

int ds_get_num_threads() { return omp_get_max_threads(); }

}  // extern "C"
