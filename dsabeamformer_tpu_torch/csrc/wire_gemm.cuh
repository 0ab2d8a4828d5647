// What the int8 kernels share (detect_power.cu, beam_voltages.cu, both on
// mma_gemm.cuh): the int8 weight operand (IntWeights), the nibble sign
// extension, the incoherent mask, the grid's span count.
//
// A mode is a set of 1, 2 or 4 int8 sub-terms [2 * a_compute, 2B] per
// channel (IntWeights) and a combine factor:
//   int8    one sub-term;
//   int8x2  two tensors, M_hi * 256 + M_lo;
//   int12   one tensor [[hi], [lo]] along K, M_hi * 16 + M_lo;
//   int13   one tensor [[h1], [l1], [h2], [l2]], (M_h1 + M_h2) * 16 +
//           (M_l1 + M_l2): h1 + h2 does not fit int8, so all four stay,
//           but the even and the odd sub-terms share an accumulator.
// The JAX kernel folds the 16 into its data operand ([16X | X], K = 4a or
// 8a); the tensor-core kernels feed 16 X against the hi sub-terms
// (mma_gemm.cuh): the same integer.
//
// The integers are exact: one sub-term's |M| <= K * 8 * 128 = 2048 *
// a_compute (K = 2 * a_compute), int8x2's |M_hi * 256 + M_lo| <= 257 * 2048
// * a_compute < 2^31 up to a_compute 4080, int13's 34 * 2048 * a_compute
// up to 30840: the int modes' only limit on a_compute (the JAX kernel's
// int32 sums have the same; past the staged tile the kernels walk K in
// slices, mma_gemm.cuh).  The caller converts to float32 once
// (rounding above 2^24, as XLA's m.astype(f32), JAX gemm.py:145, and the
// plain version's int64 -> float32 do).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dsabf {

constexpr int kMaxDynSmem = 227 * 1024;     // per block on an H100

// The incoherent sum's antenna selection: bit a of word a / 32, the first
// ceil(a_compute / 32) words used.  2048 antennas is past any a_compute
// whose weight tile fits in shared memory; the K loop reads the mask from
// device memory instead.
constexpr int kMaskWords = 64;
struct AntMask {
  uint32_t w[kMaskWords];
};

// Four 4-bit two's-complement values, one in the low nibble of each byte,
// to four int8 values.  (n & 8) * 0x1E is 0xF0 in every byte whose nibble
// is negative and cannot carry into the next byte.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t n) {
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// The int8 sub-terms of a weight mode (by value to the kernels): sub-term t
// of channel f starts at sub[t] + f * chan_stride and is [2 * a_compute,
// 2 * n_beams]; `factor` combines the hi and lo sums; the channel's scale is
// scales[f * n_scales + n_scales - 1].
constexpr int kMaxSubTerms = 4;
struct IntWeights {
  const int8_t* sub[kMaxSubTerms];
  long long chan_stride;
  int factor;
  int n_scales;
};

// Fill an IntWeights from the C interface's arguments: `fold` == 0 takes
// n_sub (1 or 2) separate tensors w0, w1 (int8, int8x2: factor 256, a scale
// per tensor); `fold` != 0 takes n_sub (2 or 4) sub-terms stacked along K
// in the one tensor w0 (int12, int13: factor 16, one scale).
inline bool make_int_weights(IntWeights& w, const void* w0, const void* w1,
                             int n_sub, int fold, int a_compute,
                             int n_beams) {
  const long long sub_elems = 2LL * a_compute * 2 * n_beams;
  if (fold ? (n_sub != 2 && n_sub != 4) : (n_sub != 1 && n_sub != 2)) {
    return false;
  }
  for (int t = 0; t < kMaxSubTerms; ++t) {
    const int8_t* base = static_cast<const int8_t*>(fold || t == 0 ? w0 : w1);
    w.sub[t] = t < n_sub ? base + (fold ? t * sub_elems : 0) : nullptr;
  }
  w.chan_stride = fold ? n_sub * sub_elems : sub_elems;
  w.factor = fold ? 16 : 256;
  w.n_scales = fold ? 1 : n_sub;
  return true;
}

// Sub-term t's pointer by selects (no dynamically indexed copy of the
// by-value parameter in local memory).
__device__ __forceinline__ const int8_t* sub_term(const IntWeights& w, int t) {
  static_assert(kMaxSubTerms == 4, "sub_term selects among four pointers");
  return t == 0 ? w.sub[0] : t == 1 ? w.sub[1] : t == 2 ? w.sub[2] : w.sub[3];
}

// What every address of a wire row is a multiple of (16, 4 or 1): the
// wire's address, n_ant (pol y's row) and the strides.  16 lets cp.async
// move 16 bytes at a time, 4 four; 1 stages the rows from byte loads.
inline int wire_align(const void* wire, int n_ant, long long time_stride,
                      long long chan_stride) {
  const unsigned long long all =
      reinterpret_cast<uintptr_t>(wire) | (unsigned long long)n_ant
      | (unsigned long long)time_stride | (unsigned long long)chan_stride;
  return all % 16 == 0 ? 16 : all % 4 == 0 ? 4 : 1;
}

// gridDim.z of a launch that walks spans: enough blocks (n_chan * chunks *
// z) for a few waves of two per SM, each block walking every z-th share of
// the spans.
inline int staged_grid_x(int n_spans, int n_chan, int chunks) {
  const int want = (2048 + n_chan * chunks - 1) / (n_chan * chunks);
  return want < n_spans ? want : n_spans;
}

}  // namespace dsabf
