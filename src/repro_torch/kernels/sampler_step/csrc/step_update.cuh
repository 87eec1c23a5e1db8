// The deterministic body of the Eq. 12 sampler step, shared by the
// sampler-step kernels (sampler_step.cu) and the megastep kernel
// (megastep/csrc/megastep.cu).  Port of ``_update`` / ``_row_update`` in
// src/repro/kernels/sampler_step/kernel.py.
//
// The multiply-adds are the explicit __fmaf_rn / __fmul_rn / __fdiv_rn that
// XLA:CPU's contraction of the reference gives (see ../ref.py), so nvcc's
// default -fmad=true cannot contract them differently.
#pragma once

namespace repro {

struct Coefs {
  float c_x0, c_dir, c_noise, sqrt_a_t, sqrt_1m_a_t;
};

// Returns x_prev without noise; writes x0 when the explicit-x0 form runs.
template <bool CLIP, bool X0_FORM>
__device__ __forceinline__ float update(float x, float e, const Coefs& c,
                                        float clip, float* x0_out) {
  if (!CLIP && !X0_FORM) {
    const float a = __fdiv_rn(c.c_x0, c.sqrt_a_t);
    const float b = __fmaf_rn(-a, c.sqrt_1m_a_t, c.c_dir);
    return __fmaf_rn(a, x, __fmul_rn(b, e));
  }
  float x0 = __fdiv_rn(__fmaf_rn(-c.sqrt_1m_a_t, e, x), c.sqrt_a_t);
  if (CLIP) {
    // NaN passes through, as jnp.clip / torch.clamp let it
    x0 = x0 < -clip ? -clip : (x0 > clip ? clip : x0);
    e = __fdiv_rn(__fmaf_rn(-c.sqrt_a_t, x0, x), c.sqrt_1m_a_t);
  }
  *x0_out = x0;
  return __fmaf_rn(c.c_x0, x0, __fmul_rn(c.c_dir, e));
}

}  // namespace repro
