// Unfused 4-bit unpack + float complex beamforming GEMM -> beam voltages for
// the float weight modes (bf16, bf16x2, f32), written by hand for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _voltage_kernel (gemm.py:427), launched by beamform_voltages
//   (pl.pallas_call, gemm.py:932), with the float branch of _accumulate
//   (gemm.py:146-160).
//
// What it computes, per channel f, sample t, pol p and beam b:
//   V[t, p, c] as detect_float.cu (float32 K-sums in ascending k, bf16x2's
//   two partial sums added hi first)
//   out[f, t, p, b] = V[t, p, b] * s, out[f, t, p, B + b] = V[t, p, B + b] * s
//   s = scales[f, n_terms-1] (1 for these modes).
//
// What bounds it on an H100: at a 128-channel DSA-10 sub-band it stores
// 4.295 GB (1.3 ms at 3.35 TB/s) against 6.9e10 float32 MACs per term
// (2.1 ms at the CUDA cores' 33.5e12 MAC/s), so operations by a little for
// one term and by twice that for bf16x2; bf16 weights on the tensor cores
// would be bound by the bytes.
//
// What the design does about it: float_gemm.cuh's staged weight tile (one
// block per channel and 32-beam tile, walking a share of the spans) and
// four-row inner loop; 8 warps take every 8th sample pair; per (sample, pol)
// row a warp stores Re at lanes b and Im at lanes B + b: two 128-byte stores.

#include <cstdint>

#include <cuda_runtime.h>

#include "float_gemm.cuh"
#include "wire_gemm.cuh"

namespace {

using namespace dsabf;

template <typename WT, int NT>
__global__ void __launch_bounds__(kFloatThreads)
beam_voltages_float_kernel(const uint8_t* __restrict__ wire,
                           const WT* __restrict__ w0,
                           const WT* __restrict__ w1,
                           const float* __restrict__ scales,
                           float* __restrict__ out,
                           int n_time, int n_beams, int n_ant, int kw,
                           int span_samples,
                           long long time_stride, long long chan_stride) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int k_rows = 4 * kw;  // K = 2 * a_compute
  float* ws = reinterpret_cast<float*>(smem);   // [term][col][K][beam]
  float* xf = ws + float_weight_words(NT, kw);  // [rows][pol][K]
  uint32_t* xi = reinterpret_cast<uint32_t*>(
      xf + (size_t)span_samples * 2 * k_rows);  // [rows][pol][kw]

  const int f = blockIdx.y;
  const int n_spans = (n_time + span_samples - 1) / span_samples;
  const int lb = threadIdx.x % kFloatBeams;
  const int g = threadIdx.x / kFloatBeams;
  const int b = blockIdx.z * kFloatBeams + lb;
  const bool active = b < n_beams;
  stage_float_weights<WT, NT>(ws, w0, w1, f, blockIdx.z * kFloatBeams,
                              n_beams, k_rows);
  const float s = scales[(long long)f * NT + (NT - 1)];
  const long long row = 2LL * n_beams;  // floats per (sample, pol) row

  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    const int t0 = span * span_samples;
    const int rows = min(span_samples, n_time - t0);
    __syncthreads();  // the previous span's readers are done
    stage_rows(xi, wire + (long long)f * chan_stride
                       + (long long)t0 * time_stride,
               rows, time_stride, n_ant, kw / 2);
    __syncthreads();
    rows_to_float(xf, xi, rows * 2, kw);
    __syncthreads();
    if (!active) continue;
    float* o = out + ((long long)f * n_time + t0) * 2 * row + b;
    for (int r = 2 * g; r < rows; r += 2 * kFloatGroups) {
      const float* xa = xf + (size_t)r * 2 * k_rows;
      const bool two = r + 1 < rows;
      float v[4][2];
      float_rows4<NT>(xa, two ? xa + 2 * k_rows : xa, ws + lb, k_rows, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // rows (r, x), (r, y), (r+1, x), (r+1, y)
        if (j == 2 && !two) break;
        const long long rp = 2LL * r + j;
        o[rp * row] = __fmul_rn(v[j][0], s);
        o[rp * row + n_beams] = __fmul_rn(v[j][1], s);
      }
    }
  }
}

template <typename WT, int NT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const void* wire, const void* w0, const void* w1,
                   const void* scales, void* out, int n_time, int n_beams,
                   int n_ant, int kw, int span_samples,
                   long long time_stride, long long chan_stride) {
  auto kernel = beam_voltages_float_kernel<WT, NT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, dim3(kFloatThreads), smem, stream>>>(
      static_cast<const uint8_t*>(wire), static_cast<const WT*>(w0),
      static_cast<const WT*>(w1), static_cast<const float*>(scales),
      static_cast<float*>(out), n_time, n_beams, n_ant, kw, span_samples,
      time_stride, chan_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); w0, w1, n_terms,
// elem_size and scales as dsabf_detect_float takes them; out f32 [n_chan,
// n_time, 2, 2*n_beams].  a_compute: any multiple of 8 up to 128.
int dsabf_beam_voltages_float(const void* wire, const void* w0,
                              const void* w1, const void* scales, void* out,
                              int n_chan, int n_time, int n_beams, int n_ant,
                              int a_compute, int n_terms, int elem_size,
                              long long time_stride, long long chan_stride,
                              void* stream) {
  const int kw = a_compute / 2;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || n_time < 1 ||
      n_ant % 4 || a_compute < 8 || a_compute % 8 || a_compute > n_ant ||
      a_compute > kMaxAnt ||
      !((elem_size == 4 && n_terms == 1) ||
        (elem_size == 2 && (n_terms == 1 || n_terms == 2)))) {
    return int(cudaErrorInvalidValue);
  }
  const int span = float_span_samples(kw, n_terms, 2, kFloatVoltSpan) & ~1;
  if (span == 0) return int(cudaErrorInvalidValue);
  const size_t smem = float_weight_words(n_terms, kw) * sizeof(float)
                      + size_t(span) * float_sample_bytes(kw);
  const int n_spans = (n_time + span - 1) / span;
  const int chunks = (n_beams + kFloatBeams - 1) / kFloatBeams;
  const dim3 grid(staged_grid_x(n_spans, n_chan, chunks), n_chan, chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSABF_LAUNCH(WT, NT)                                                \
  return int(launch<WT, NT>(grid, smem, st, wire, w0, w1, scales, out,     \
                            n_time, n_beams, n_ant, kw, span, time_stride, \
                            chan_stride))
  if (elem_size == 4) DSABF_LAUNCH(float, 1);
  if (n_terms == 1) DSABF_LAUNCH(uint16_t, 1);
  DSABF_LAUNCH(uint16_t, 2);
#undef DSABF_LAUNCH
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
