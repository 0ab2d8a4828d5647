// The unpack and float GEMM that the float weight modes' kernels start from
// (detect_float.cu, beam_voltages_float.cu): the JAX package's _build_x and
// the float branch of _accumulate (dsabeamformer_tpu/ops/gemm.py:146-160)
// for bf16, bf16x2 and f32 weights, as fmaf on the CUDA cores.
//
// What it computes: X = [re | im] (the 4-bit voltages, exact in any float
// type) times each weight term [2 * a_compute, 2B], accumulated in float32
// over K in ascending order; bf16x2 adds its two terms' partial sums, hi
// first.  A bfloat16 weight times a 4-bit voltage is exact in float32 (8 + 4
// significant bits), so only the K-sum rounds.  No tensor-core instruction:
// a float32 weight through a TF32 mma would keep 10 of its 23 mantissa bits,
// and f32 is the mode everything else is validated against.
//
// One kernel shape serves every a_compute from 8 to 128: a block is
// kFloatGroups warps, each warp kFloatBeams = 32 consecutive beams of one
// tile; the tile's weight columns, every term, are staged once per block
// into shared memory as float32, laid out [term][re|im][k][beam] (a warp
// reads 32 consecutive words, one per bank), whatever type they have in
// device memory.  The span's wire bytes are unpacked to int8 words
// (wire_gemm.cuh stage_rows; the side outputs read those) and then widened
// to float rows once per block and span, so the inner loop is one broadcast
// float4 load of X per four k and row, one weight load per k and column, and
// fmaf: float_rows4 feeds each weight to four rows (both pols of two
// samples), as staged_rows4 does for dp4a.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wire_gemm.cuh"

namespace dsabf {

constexpr int kFloatBeams = 32;   // beams of a weight tile: one warp
constexpr int kFloatGroups = 8;   // warps of a block, each on its own rows
constexpr int kFloatThreads = kFloatBeams * kFloatGroups;
constexpr int kFloatVoltSpan = 64;  // most samples a voltage block stages

// A weight element as float32: float as it is, bfloat16 given as its bits.
__device__ __forceinline__ float weight_to_float(float v) { return v; }
__device__ __forceinline__ float weight_to_float(uint16_t v) {
  return __uint_as_float(uint32_t(v) << 16);
}

// Shared memory of a float block: the weight tile as float32, then the
// span's float rows [rows][pol][K], then its int8 words [rows][pol][kw]
// (kw = K / 4 words per row).
__host__ __device__ constexpr size_t float_weight_words(int nterms, int kw) {
  return size_t(nterms) * 2 * (4 * kw) * kFloatBeams;
}
__host__ __device__ constexpr size_t float_sample_bytes(int kw) {
  return size_t(2) * (4 * kw) * sizeof(float) + size_t(2) * kw * 4;
}
__host__ __device__ constexpr size_t float_smem_budget() {
  return kMaxDynSmem - 2 * kMaxAnt * sizeof(int);  // less the SK scratch
}

// Samples a block can stage beside its weight tile (0: not even `least`).
inline int float_span_samples(int kw, int nterms, int least, int most) {
  const size_t wbytes = float_weight_words(nterms, kw) * sizeof(float);
  const size_t per = float_sample_bytes(kw);
  if (wbytes + per * least > float_smem_budget()) return 0;
  const size_t fit = (float_smem_budget() - wbytes) / per;
  return int(fit < size_t(most) ? fit : size_t(most));
}

// The weight tile of beams b0 .. b0 + kFloatBeams - 1 of channel f into ws
// [term][col][K][kFloatBeams] (col 0 = Re column b, 1 = Im column B + b) as
// float32; zeros for beams past n_beams.  Terms are [n_chan, K, 2 * n_beams].
template <typename WT, int NT>
__device__ __forceinline__ void stage_float_weights(
    float* ws, const WT* w0, const WT* w1, int f, int b0, int n_beams,
    int k_rows) {
  const long long b2 = 2LL * n_beams;
  const int total = NT * 2 * k_rows * kFloatBeams;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int b = b0 + i % kFloatBeams;
    const int row = i / kFloatBeams;  // (term * 2 + col) * K + k
    const int k = row % k_rows;
    const int tc = row / k_rows;
    float v = 0.f;
    if (b < n_beams) {
      const WT* wt = ((tc >> 1) ? w1 : w0) + ((long long)f * k_rows + k) * b2
                     + (tc & 1) * n_beams + b;
      v = weight_to_float(*wt);
    }
    ws[i] = v;
  }
}

// The span's int8 words xi [rows2][kw] (stage_rows' layout, rows2 = 2 *
// samples) widened to float rows xf [rows2][4 * kw]: byte j of word w is
// float 4 * w + j, so a row is [re | im] in the weight rows' order.
__device__ __forceinline__ void rows_to_float(float* xf, const uint32_t* xi,
                                              int rows2, int kw) {
  float4* dst = reinterpret_cast<float4*>(xf);
  for (int i = threadIdx.x; i < rows2 * kw; i += blockDim.x) {
    const uint32_t v = xi[i];
    dst[i] = make_float4(float(int8_t(uint8_t(v))),
                         float(int8_t(uint8_t(v >> 8))),
                         float(int8_t(uint8_t(v >> 16))),
                         float(int8_t(uint8_t(v >> 24))));
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// Four float rows -- xa, xa + K (sample A, pols x and y) and xb, xb + K
// (sample B) -- times this thread's beam's staged columns (wb = ws + the
// beam's index in the tile): v[row][col], col 0 Re, 1 Im, the terms'
// partial sums added in term order.
template <int NT>
__device__ __forceinline__ void float_rows4(const float* xa, const float* xb,
                                            const float* wb, int k_rows,
                                            float (&v)[4][2]) {
  const float4* xr[4] = {reinterpret_cast<const float4*>(xa),
                         reinterpret_cast<const float4*>(xa + k_rows),
                         reinterpret_cast<const float4*>(xb),
                         reinterpret_cast<const float4*>(xb + k_rows)};
  const int plane = k_rows * kFloatBeams;  // floats between (term, col) planes
  float acc[4][NT][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int tc = 0; tc < 2 * NT; ++tc) acc[r][tc >> 1][tc & 1] = 0.f;
  }
  for (int k4 = 0; k4 < k_rows / 4; ++k4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = xr[r][k4];
    const float* wq = wb + k4 * 4 * kFloatBeams;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int tc = 0; tc < 2 * NT; ++tc) {
        const float w = wq[tc * plane + e * kFloatBeams];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][tc >> 1][tc & 1] =
              __fmaf_rn(lane_of(x[r], e), w, acc[r][tc >> 1][tc & 1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      v[r][c] = NT == 2 ? __fadd_rn(acc[r][0][c], acc[r][NT - 1][c])
                        : acc[r][0][c];
    }
  }
}

}  // namespace dsabf
