// What follows the GEMM in the detect kernels, whatever the weight mode
// (detect_power.cu for the int8 modes, detect_float.cu for the float ones):
// the detection of one sample (power or I, Q, U, V), the store of one output
// row (float32, or the uint8 epilogue), and the side outputs (incoherent sum
// and spectral-kurtosis accumulators) from the span's unpacked int8 [re | im]
// words, which no weight mode changes (JAX gemm.py:281-286).

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

// Word i of the mask by selects (no dynamically indexed copy of the
// by-value parameter in local memory).
__device__ __forceinline__ uint32_t mask_word(const AntMask& m, int i) {
  static_assert(kMaxAnt / 32 == 4, "mask_word selects among four words");
  return i == 0 ? m.w[0] : i == 1 ? m.w[1] : i == 2 ? m.w[2] : m.w[3];
}

// The side outputs of the span staged in xs ([rows][pol][kw], n_rows_out
// output rows of navg samples): the incoherent sums into inco_row[0 ..
// n_rows_out) and the SK sums added to sk_chan[2 * ac] (either pointer
// null = not computed; both block-uniform).  sk_part [2 * ac] must be zero
// and xs complete (a __syncthreads) before the call.
__device__ __forceinline__ void side_outputs(
    const uint32_t* xs, int kw, int ac, int n_rows_out, int navg,
    const AntMask& mask, float* inco_row, int* sk_part,
    unsigned long long* sk_chan) {
  const int aw = kw / 2;
  const int rows = n_rows_out * navg;
  if (inco_row) {
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int items = navg * 2 * aw;  // (sample, pol, word) of one row
    for (int o = threadIdx.x >> 5; o < n_rows_out; o += n_warps) {
      int acc = 0;
      for (int i = lane; i < items; i += 32) {
        const int w = i % aw;
        const uint32_t* row = xs + (o * navg * 2 + i / aw) * kw;
        const uint32_t m = byte_mask((mask_word(mask, w >> 3)
                                      >> (4 * (w & 7))) & 0xFu);
        acc = masked_power(row[w], row[aw + w], m, acc);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, d);
      }
      if (lane == 0) inco_row[o] = float(acc);
    }
  }
  if (sk_chan) {
    // `per` threads per antenna, each taking every per-th (sample, pol)
    // row; the threads past per * ac sit out (ac need not divide the
    // block).  Per span an antenna sums 2 * rows values of p <= 128
    // (p^2 <= 2^14), and the span's staged rows (8 * a_compute bytes
    // each) fit in 227 KB, so rows < 2^13 and S2 < 2^28: int32 is exact.
    const int per = blockDim.x / ac;
    if (threadIdx.x < per * ac) {
      const int a = threadIdx.x % ac;
      const int w = a >> 2;
      const int sh = 8 * (a & 3);
      int s1 = 0, s2 = 0;
      for (int rp = threadIdx.x / ac; rp < rows * 2; rp += per) {
        const uint32_t* row = xs + rp * kw;
        const int re = int(int8_t(uint8_t(row[w] >> sh)));
        const int im = int(int8_t(uint8_t(row[aw + w] >> sh)));
        const int p = re * re + im * im;
        s1 += p;
        s2 += p * p;
      }
      atomicAdd(&sk_part[a], s1);
      atomicAdd(&sk_part[ac + a], s2);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * ac; i += blockDim.x) {
      atomicAdd(sk_chan + i, (unsigned long long)sk_part[i]);
    }
  }
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
