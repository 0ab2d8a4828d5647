// What follows the GEMM in the detect kernel (detect_power.cu), whatever the
// weight mode: the detection of one sample (power or I, Q, U, V), the store
// of one output row (float32, or the uint8 epilogue), and the helpers of the
// incoherent sum over masked antennas (JAX gemm.py:281-322).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "wire_gemm.cuh"

namespace dsabf {

// Midpoint of the signed Q/U/V planes in an 8-bit Stokes product
// (ops/gemm.py STOKES_QUV_OFFSET).
constexpr float kQuvOffset = 128.f;

// Four mask bits (one per antenna of a word) to a byte mask: 0xFF in byte i
// when bit i is set.
__device__ __forceinline__ uint32_t byte_mask(uint32_t bits) {
  const uint32_t spread = (bits & 1u) | ((bits & 2u) << 7) |
                          ((bits & 4u) << 14) | ((bits & 8u) << 21);
  return spread * 0xFFu;
}

// re^2 + im^2 summed over the antennas (bytes) of one unpacked word pair
// that the byte mask m selects, added to acc.
__device__ __forceinline__ int masked_power(uint32_t re, uint32_t im,
                                            uint32_t m, int acc) {
  acc = __dp4a(int(re), int(re & m), acc);
  return __dp4a(int(im), int(im & m), acc);
}

// One sample's detection added to the row sums: acc[0] (power, or I) and,
// for Stokes, Q, U, V.  vr/vi: the beam voltage of pol x (0) and y (1).
// Explicit rounding: no FMA contraction, so the Stokes I plane is the power
// output to the bit.
template <bool STOKES>
__device__ __forceinline__ void detect_sample(const float (&vr)[2],
                                              const float (&vi)[2],
                                              float (&acc)[STOKES ? 4 : 1]) {
  const float px = __fadd_rn(__fmul_rn(vr[0], vr[0]), __fmul_rn(vi[0], vi[0]));
  const float py = __fadd_rn(__fmul_rn(vr[1], vr[1]), __fmul_rn(vi[1], vi[1]));
  acc[0] = __fadd_rn(acc[0], __fadd_rn(px, py));
  if constexpr (STOKES) {
    const float cr = __fadd_rn(__fmul_rn(vr[0], vr[1]),
                               __fmul_rn(vi[0], vi[1]));
    const float ci = __fsub_rn(__fmul_rn(vi[0], vr[1]),
                               __fmul_rn(vr[0], vi[1]));
    acc[1] = __fadd_rn(acc[1], __fsub_rn(px, py));
    acc[2] = __fadd_rn(acc[2], __fadd_rn(cr, cr));
    acc[3] = __fadd_rn(acc[3], __fadd_rn(ci, ci));
  }
}

// One output row's planes, scaled by s^2, to dst[k * n_beams] (float32, or
// the uint8 epilogue with this beam's scale qs).
template <typename OutT, bool STOKES>
__device__ __forceinline__ void store_row(const float (&acc)[STOKES ? 4 : 1],
                                          float s2, float qs, OutT* dst,
                                          int n_beams) {
  constexpr int NP = STOKES ? 4 : 1;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float v = __fmul_rn(acc[k], s2);
    if constexpr (std::is_same<OutT, uint8_t>::value) {
      // rintf rounds half to even, as jnp.rint and torch.round do; the
      // clamp follows the rounding, as in gemm.py:277.
      const float y = k > 0 ? __fmaf_rn(v, qs, kQuvOffset) : __fmul_rn(v, qs);
      dst[k * n_beams] = uint8_t(fminf(fmaxf(rintf(y), 0.f), 255.f));
    } else {
      dst[k * n_beams] = v;
    }
  }
}

}  // namespace dsabf
