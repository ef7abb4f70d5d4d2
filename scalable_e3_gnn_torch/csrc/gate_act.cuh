// The scalar activation of the generic message kernels' gate (#8-#14),
// shared by fused_message_generic_tab_fwd.cu and fused_message_generic_tab_bwd.cu.
//
// The activation is a compile-time constant of the library: GENERIC_ACT, the
// code of scalable_e3_gnn_torch/ops/gate.py's ACTIVATIONS (the wrapper
// builds one library of each source per code, kernels/build.py variants).
//   0 silu: the selection form of Gate.fast_apply on every lane, the JAX
//     kernels' form for silu/sigmoid (act_f and act_vjp are not used);
//   1 tanh, 2 gelu (jax.nn.gelu's default tanh form), 3 relu, 4 softplus
//     (JAX's logaddexp(x, 0)): JAX's concat form, Gate.__call__, on the
//     scalar lanes (each lane j with sel[j] == j; a gated lane selects a gate
//     column past dk): rnd(act(y)) in fp32, and in the backward rnd(the
//     cotangent of JAX's AD, operation by operation, in fp32).
// Accurate transcendentals (tanhf, expf, log1pf), not the .approx forms,
// and every product and sum rounded as written (__fmul_rn, __fadd_rn: no
// contraction into an FMA), as the plain versions compute them.  Adding an
// activation: a code here (act_f, act_vjp) and an entry in ACTIVATIONS.

#pragma once

#ifndef GENERIC_ACT
#define GENERIC_ACT 0
#endif

namespace gact {

enum : int { kSilu = 0, kTanh = 1, kGeluTanh = 2, kRelu = 3, kSoftplus = 4 };
constexpr int kAct = GENERIC_ACT;
static_assert(kAct >= kSilu && kAct <= kSoftplus, "GENERIC_ACT: a code of ops/gate.py");

// sqrt(2 / pi) in fp32, as jax.nn.gelu rounds it
constexpr float kGeluS = 0.7978845834732056f;
constexpr float kGeluC = 0.044715f;

__device__ __forceinline__ float softplus_f(float x) {
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// act(x) in fp32
template <int ACT>
__device__ __forceinline__ float act_f(float x) {
  if constexpr (ACT == kTanh) {
    return tanhf(x);
  } else if constexpr (ACT == kGeluTanh) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float t = tanhf(__fmul_rn(kGeluS, __fadd_rn(x, __fmul_rn(kGeluC, x3))));
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, t)));
  } else if constexpr (ACT == kRelu) {
    return fmaxf(x, 0.f);
  } else if constexpr (ACT == kSoftplus) {
    return softplus_f(x);
  } else {
    return x;  // silu: not called (the selection form)
  }
}

// the cotangent of x for act's output cotangent g, as JAX's AD computes it:
// tanh (g + g t)(1 - t) transposed, c + c t with c = g (1 - t); gelu its
// product, tanh and cubic branches, added in JAX's order; relu g where x > 0
// (0 at 0, jax.nn.relu's custom JVP); softplus g exp(x - softplus(x))
// (logaddexp's custom JVP)
template <int ACT>
__device__ __forceinline__ float act_vjp(float x, float g) {
  if constexpr (ACT == kTanh) {
    const float t = tanhf(x);
    const float c = __fmul_rn(g, __fsub_rn(1.f, t));
    return __fadd_rn(c, __fmul_rn(c, t));
  } else if constexpr (ACT == kGeluTanh) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float t = tanhf(__fmul_rn(kGeluS, __fadd_rn(x, __fmul_rn(kGeluC, x3))));
    const float q = __fmul_rn(__fmul_rn(0.5f, __fmul_rn(x, g)), __fsub_rn(1.f, t));
    const float du = __fmul_rn(kGeluS, __fadd_rn(q, __fmul_rn(q, t)));
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, t));
    return __fadd_rn(__fadd_rn(__fmul_rn(g, cdf), du),
                     __fmul_rn(__fmul_rn(kGeluC, du), __fmul_rn(3.f, __fmul_rn(x, x))));
  } else if constexpr (ACT == kRelu) {
    return x > 0.f ? g : 0.f;
  } else if constexpr (ACT == kSoftplus) {
    return __fmul_rn(g, expf(__fsub_rn(x, softplus_f(x))));
  } else {
    return g;  // silu: not called (the selection form)
  }
}

}  // namespace gact
