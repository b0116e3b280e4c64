// Host-offload fused optimizers (ZeRO-Offload tier): a copy of the JAX package's
// deepspeed_tpu/ops/csrc/adam/cpu_adam.cpp, with the same three C entry points, so
// both packages compile one source the same way and their host steps agree bit for bit.
//
// Behavioural equivalent of reference csrc/adam/cpu_adam.cpp (Adam_Optimizer::Step_8) and
// csrc/adagrad/cpu_adagrad.cpp, whose AVX intrinsics (csrc/includes/simd.h:17) exist because
// eager loops can't vectorise. Here SIMD comes from the compiler: `#pragma omp parallel for
// simd` plus -O3 -march=native emits the same packed FMA sequence without hand-written
// intrinsics, and parallelises across cores for multi-GB optimizer states.
//
// All buffers are flat, contiguous fp32. Bias corrections (1 - beta^t) are computed by the
// Python caller and passed in (1.0 disables). The formula is FusedAdam's, except that the
// denominator is sqrt(v) * rsqrt(bc2) + eps where deepspeed_tpu_torch/ops/adam/fused_adam.py
// takes sqrt(v / bc2) + eps: offloaded training is close to in-device training, not equal.
// This runs on the host and replaces no TPU kernel; it is bound by memory traffic
// (p, m, v read and written, g read: 28 bytes an element).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

void ds_adam_step(float* __restrict p, float* __restrict m, float* __restrict v,
                  const float* __restrict g, int64_t n,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adam_w_mode, float bc1, float bc2) {
  const float one_minus_b1 = 1.0f - beta1;
  const float one_minus_b2 = 1.0f - beta2;
  const float inv_bc1 = 1.0f / bc1;
  const float inv_sqrt_bc2 = 1.0f / sqrtf(bc2);
  const bool l2_decay = (weight_decay != 0.0f) && !adam_w_mode;
  const bool decoupled_decay = (weight_decay != 0.0f) && adam_w_mode;

#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (l2_decay) grad += weight_decay * p[i];
    const float mi = beta1 * m[i] + one_minus_b1 * grad;
    const float vi = beta2 * v[i] + one_minus_b2 * grad * grad;
    m[i] = mi;
    v[i] = vi;
    // denom = sqrt(v/bc2) + eps, written as sqrt(v)*rsqrt(bc2) for one div per element
    const float denom = sqrtf(vi) * inv_sqrt_bc2 + eps;
    float delta = (mi * inv_bc1) / denom;
    if (decoupled_decay) delta += weight_decay * p[i];
    p[i] -= lr * delta;
  }
}

void ds_adagrad_step(float* __restrict p, float* __restrict s,
                     const float* __restrict g, int64_t n,
                     float lr, float eps, float weight_decay) {
  const bool decay = weight_decay != 0.0f;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float grad = g[i];
    if (decay) grad += weight_decay * p[i];
    const float si = s[i] + grad * grad;
    s[i] = si;
    p[i] -= lr * grad / (sqrtf(si) + eps);
  }
}

// fp32 -> bfloat16 (round to nearest even), for pushing updated masters back to the chip
// in compute dtype without a second full-precision pass in Python.
void ds_fp32_to_bf16(const float* __restrict in, uint16_t* __restrict out, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &in[i], sizeof(bits));
    if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {
      out[i] = static_cast<uint16_t>((bits >> 16) | 0x0040u);  // quiet NaN
    } else {
      const uint32_t rounding = 0x7FFFu + ((bits >> 16) & 1u);
      out[i] = static_cast<uint16_t>((bits + rounding) >> 16);
    }
  }
}

}  // extern "C"
