// The unpack and GEMM that both beamforming kernels start from
// (detect_power.cu, beam_voltages.cu): the JAX package's _build_x and
// _accumulate (dsabeamformer_tpu/ops/gemm.py:97-145) for the int8 and
// int8x2 weight modes, as __dp4a on the CUDA cores.
//
//   - stage_rows: a block stages its span's wire bytes once into shared
//     memory, already unpacked into int8 [re | im] words (four antennas per
//     32-bit word, the dp4a operand).  Row rp = 2 * sample + pol.  The
//     stride arguments let one kernel read both the time-major tfpa form
//     [T, F*P*A] and the channel-major ftpa form [F, T, P*A]; the corner
//     turn happens in these loads.
//   - load_beam_weights: each thread owns one beam and keeps that beam's Re
//     (column b) and Im (column B + b) weight columns, for every term, in
//     registers (K/4 words each).
//   - beam_row: one staged row times those weights, the integer Re and Im
//     of the beam voltage (int8x2: M_hi * 256 + M_lo, exact: |M| < 2^27).
//     All threads of a warp read the same row, so the loads are broadcasts.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dsabf {

// Time samples staged in shared memory per block: 256 samples * 2 pols *
// 16 words * 4 B = 32 KB at a_compute=32.
constexpr int kSpanSamples = 256;
constexpr int kMaxThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;
constexpr int kMaxAnt = 32;  // a_compute of the largest instantiation

// Four 4-bit two's-complement values, one in the low nibble of each byte,
// to four int8 values.  (n & 8) * 0x1E is 0xF0 in every byte whose nibble
// is negative and cannot carry into the next byte.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t n) {
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// Stage `rows` samples (both pols) starting at `base` into xs
// [rows][pol][KW]: word w of (sample r, pol p) <- wire bytes 4w..4w+3 of
// that pol; the first AW words hold re, the next AW im.
template <int AW>
__device__ __forceinline__ void stage_rows(uint32_t* xs, const uint8_t* base,
                                           int rows, long long time_stride,
                                           int n_ant) {
  constexpr int KW = 2 * AW;
  for (int i = threadIdx.x; i < rows * 2 * AW; i += blockDim.x) {
    const int w = i % AW;
    const int rp = i / AW;  // r * 2 + p
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        base + (long long)(rp >> 1) * time_stride + (rp & 1) * n_ant + 4 * w);
    uint32_t* row = xs + rp * KW;
    row[w] = sign_extend_nibbles((v >> 4) & 0x0F0F0F0Fu);  // re: high nibbles
    row[AW + w] = sign_extend_nibbles(v & 0x0F0F0F0Fu);    // im: low nibbles
  }
}

// Beam b's Re and Im weight columns of channel f, every term, packed four
// K rows per word so that byte i pairs with X's byte i (zeros when the
// thread has no beam).  Terms are int8 [n_chan, 4*KW, 2*n_beams].
template <int KW, int NTERMS>
__device__ __forceinline__ void load_beam_weights(
    uint32_t (&wre)[NTERMS][KW], uint32_t (&wim)[NTERMS][KW],
    const int8_t* w_hi, const int8_t* w_lo, int f, int b, int n_beams,
    bool active) {
  const long long b2 = 2LL * n_beams;
#pragma unroll
  for (int term = 0; term < NTERMS; ++term) {
    const int8_t* wt = (term == 0 ? w_hi : w_lo) + (long long)f * (4 * KW) * b2;
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      uint32_t r = 0, m = 0;
      if (active) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int8_t* wrow = wt + (4 * q + i) * b2;
          r |= uint32_t(uint8_t(wrow[b])) << (8 * i);
          m |= uint32_t(uint8_t(wrow[n_beams + b])) << (8 * i);
        }
      }
      wre[term][q] = r;
      wim[term][q] = m;
    }
  }
}

// One staged (sample, pol) row times this beam's weights: the beam
// voltage's Re and Im in units of the last term's scale.
template <int KW, int NTERMS>
__device__ __forceinline__ void beam_row(const uint32_t* xrow,
                                         const uint32_t (&wre)[NTERMS][KW],
                                         const uint32_t (&wim)[NTERMS][KW],
                                         int& br, int& bi) {
  const uint4* x4 = reinterpret_cast<const uint4*>(xrow);
  int mre[NTERMS], mim[NTERMS];
#pragma unroll
  for (int term = 0; term < NTERMS; ++term) mre[term] = mim[term] = 0;
#pragma unroll
  for (int q = 0; q < KW / 4; ++q) {
    const uint4 x = x4[q];
    const int xw[4] = {int(x.x), int(x.y), int(x.z), int(x.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int term = 0; term < NTERMS; ++term) {
        mre[term] = __dp4a(xw[e], int(wre[term][4 * q + e]), mre[term]);
        mim[term] = __dp4a(xw[e], int(wim[term][4 * q + e]), mim[term]);
      }
    }
  }
  br = mre[0];
  bi = mim[0];
  if (NTERMS == 2) {
    // s_hi == 256 * s_lo exactly; a multiply, since a left shift of a
    // negative int is undefined in C++17.
    br = mre[0] * 256 + mre[1];
    bi = mim[0] * 256 + mim[1];
  }
}

}  // namespace dsabf
