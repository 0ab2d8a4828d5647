// Unfused 4-bit unpack + int8 complex beamforming GEMM -> beam voltages,
// written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _voltage_kernel (gemm.py:427), launched by beamform_voltages
//   (pl.pallas_call, gemm.py:932), in the int8 and int8x2 weight modes.
//   The JAX wrapper's TPU-only parts stay out: the materialized tfpa corner
//   turn (this kernel reads tfpa through its strides) and shrink_tiles.
//
// What it computes, per channel f, sample t, pol p and beam b:
//   M[t, p, c] = sum_k X[t, p, k] * W_term[f, k, c]  (int32, exact; int8x2
//                combines M_hi * 256 + M_lo), X = [re | im] as detect_power.cu
//   out[f, t, p, b]     = f32(M[t, p, b])     * s   (Re)
//   out[f, t, p, B + b] = f32(M[t, p, B + b]) * s   (Im)
//   s = scales[f, n_terms-1]: one conversion and one rounded multiply, so the
//   result is the plain PyTorch version's (and the JAX kernel's) to the bit.
//
// What bounds it on an H100: device-memory bytes.  The output is 8 bytes
// per (channel, sample, pol, beam), 16x the f32 power product: at a
// 128-channel DSA-10 sub-band (a_compute 32, 256 beams, 8192 samples) it
// stores 4.295 GB (4.37 GB moved with the wire slots and weights read)
// against 1.37e11 int8 MACs (int8x2), i.e. 1.30 ms at 3.35 TB/s against
// 0.139 ms at the dense int8 tensor-core peak.  The MACs
// run as __dp4a on the CUDA cores here (as in detect_power.cu), whose rate
// is far below that peak, so which of the two limits this kernel is a
// measurement (chip_smoke.py [voltages]).
//
// At a 128-channel DSA-110 sub-band (a_compute 128, 512 beams, 4096
// samples) it stores the same 4.295 GB against 5.5e11 int8 MACs: 1.32 ms by
// bytes against 0.56 ms by operations.
//
// What the design does about it: every wire byte is read once per beam
// chunk, every output byte written once, and the stores are coalesced.
//   - Register path (a_compute 8, 16, 32; beam_voltages_kernel): one thread
//     block per (span of kSpanSamples samples, channel, chunk of beams); the
//     span is staged once into shared memory, unpacked (wire_gemm.cuh), and
//     every thread owns one beam with its weight columns in registers.
//   - Staged path (a_compute 40..128; beam_voltages_staged_kernel): one
//     block per (channel, chunk of 64 beams) and a share of its spans of
//     kStagedSpan samples; the beam tile's weight columns are staged into
//     shared memory once (wire_gemm.cuh), and 4 groups of 64 threads take
//     every 4th sample pair, four rows per weight word.
//   - Per (sample, pol) row the warp's 32 consecutive beams store Re at
//     lanes b and Im at lanes B + b of the [f, t, p, :] row: two 128-byte
//     stores per warp and row.

#include <cstdint>

#include <cuda_runtime.h>

#include "wire_gemm.cuh"

namespace {

using namespace dsabf;

template <int KW, int NTERMS>
__global__ void __launch_bounds__(kMaxThreads)
beam_voltages_kernel(const uint8_t* __restrict__ wire,
                     const int8_t* __restrict__ w_hi,
                     const int8_t* __restrict__ w_lo,
                     const float* __restrict__ scales,
                     float* __restrict__ out,
                     int n_time, int n_beams, int n_ant,
                     long long time_stride, long long chan_stride) {
  constexpr int AW = KW / 2;
  extern __shared__ __align__(16) uint32_t xs[];  // [rows][pol][KW]

  const int f = blockIdx.y;
  const int t0 = blockIdx.x * kSpanSamples;
  const int rows = min(kSpanSamples, n_time - t0);
  stage_rows(xs, wire + (long long)f * chan_stride
                     + (long long)t0 * time_stride,
             rows, time_stride, n_ant, AW);

  const int b = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = b < n_beams;
  uint32_t wre[NTERMS][KW];
  uint32_t wim[NTERMS][KW];
  load_beam_weights<KW, NTERMS>(wre, wim, w_hi, w_lo, f, b, n_beams, active);
  __syncthreads();
  if (!active) return;

  const float s = scales[(long long)f * NTERMS + (NTERMS - 1)];
  const long long row = 2LL * n_beams;  // floats per (sample, pol) row
  float* o = out + ((long long)f * n_time + t0) * 2 * row + b;
  for (int rp = 0; rp < rows * 2; ++rp) {
    int br, bi;
    beam_row<KW, NTERMS>(xs + rp * KW, wre, wim, br, bi);
    o[rp * row] = __fmul_rn(float(br), s);
    o[rp * row + n_beams] = __fmul_rn(float(bi), s);
  }
}

template <int NTERMS>
__global__ void __launch_bounds__(kStagedThreads, 2)
beam_voltages_staged_kernel(const uint8_t* __restrict__ wire,
                            const int8_t* __restrict__ w_hi,
                            const int8_t* __restrict__ w_lo,
                            const float* __restrict__ scales,
                            float* __restrict__ out,
                            int n_time, int n_beams, int n_ant, int kw,
                            long long time_stride, long long chan_stride) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ws = smem;                                    // weight tile
  uint32_t* xs = smem + staged_weight_words(NTERMS, kw);  // [rows][pol][kw]

  const int f = blockIdx.y;
  const int n_spans = (n_time + kStagedSpan - 1) / kStagedSpan;
  const int lb = threadIdx.x % kStagedBeams;
  const int g = threadIdx.x / kStagedBeams;
  const int b = blockIdx.z * kStagedBeams + lb;
  const bool active = b < n_beams;
  stage_beam_weights<NTERMS>(ws, w_hi, w_lo, f, blockIdx.z * kStagedBeams,
                             n_beams, kw);
  const float s = scales[(long long)f * NTERMS + (NTERMS - 1)];
  const long long row = 2LL * n_beams;  // floats per (sample, pol) row

  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    const int t0 = span * kStagedSpan;
    const int rows = min(kStagedSpan, n_time - t0);
    __syncthreads();  // the previous span's readers are done
    stage_rows(xs, wire + (long long)f * chan_stride
                       + (long long)t0 * time_stride,
               rows, time_stride, n_ant, kw / 2);
    __syncthreads();
    if (!active) continue;
    float* o = out + ((long long)f * n_time + t0) * 2 * row + b;
    for (int r = 2 * g; r < rows; r += 2 * kStagedGroups) {
      const uint32_t* xa = xs + r * 2 * kw;
      const bool two = r + 1 < rows;
      int m[4][NTERMS][2];
      staged_rows4<NTERMS>(xa, two ? xa + 2 * kw : xa, ws + lb, kw, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // rows (r, x), (r, y), (r+1, x), (r+1, y)
        if (j == 2 && !two) break;
        int br, bi;
        staged_voltage<NTERMS>(m, j, br, bi);
        const long long rp = 2LL * r + j;
        o[rp * row] = __fmul_rn(float(br), s);
        o[rp * row + n_beams] = __fmul_rn(float(bi), s);
      }
    }
  }
}

template <int KW, int NTERMS>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   const void* wire, const void* w_hi, const void* w_lo,
                   const void* scales, void* out, int n_time, int n_beams,
                   int n_ant, long long time_stride, long long chan_stride) {
  beam_voltages_kernel<KW, NTERMS><<<grid, block, smem, stream>>>(
      static_cast<const uint8_t*>(wire), static_cast<const int8_t*>(w_hi),
      static_cast<const int8_t*>(w_lo), static_cast<const float*>(scales),
      static_cast<float*>(out), n_time, n_beams, n_ant, time_stride,
      chan_stride);
  return cudaGetLastError();
}

// The staged kernel's shared memory is above the 48 KB default: raise the
// instantiation's limit to what this launch needs, then launch.
template <int NTERMS>
cudaError_t launch_staged(dim3 grid, size_t smem, cudaStream_t stream,
                          const void* wire, const void* w_hi, const void* w_lo,
                          const void* scales, void* out, int n_time,
                          int n_beams, int n_ant, int kw,
                          long long time_stride, long long chan_stride) {
  auto kernel = beam_voltages_staged_kernel<NTERMS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, dim3(kStagedThreads), smem, stream>>>(
      static_cast<const uint8_t*>(wire), static_cast<const int8_t*>(w_hi),
      static_cast<const int8_t*>(w_lo), static_cast<const float*>(scales),
      static_cast<float*>(out), n_time, n_beams, n_ant, kw, time_stride,
      chan_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride), w_hi/w_lo int8
// [n_chan, 2*a_compute, 2*n_beams] (w_lo unused when n_terms == 1), scales
// f32 [n_chan, n_terms], out f32 [n_chan, n_time, 2, 2*n_beams].
// a_compute 8, 16, 32 run the register path; 40..128 in steps of 8 the
// staged path; anything else is refused.
int dsabf_beam_voltages(const void* wire, const void* w_hi, const void* w_lo,
                        const void* scales, void* out, int n_chan, int n_time,
                        int n_beams, int n_ant, int a_compute, int n_terms,
                        long long time_stride, long long chan_stride,
                        void* stream) {
  const int kw = a_compute / 2;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || n_time < 1 ||
      n_ant % 4 || a_compute < 8 || a_compute % 8 || a_compute > n_ant ||
      a_compute > kMaxAnt || (n_terms != 1 && n_terms != 2)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_compute > kMaxRegAnt) {
    const size_t smem = (staged_weight_words(n_terms, kw)
                         + size_t(kStagedSpan) * 2 * kw) * sizeof(uint32_t);
    const int n_spans = (n_time + kStagedSpan - 1) / kStagedSpan;
    const int chunks = (n_beams + kStagedBeams - 1) / kStagedBeams;
    const dim3 grid(staged_grid_x(n_spans, n_chan, chunks), n_chan, chunks);
    return int(n_terms == 1
                   ? launch_staged<1>(grid, smem, st, wire, w_hi, w_lo,
                                      scales, out, n_time, n_beams, n_ant, kw,
                                      time_stride, chan_stride)
                   : launch_staged<2>(grid, smem, st, wire, w_hi, w_lo,
                                      scales, out, n_time, n_beams, n_ant, kw,
                                      time_stride, chan_stride));
  }
  const size_t smem = size_t(kSpanSamples) * 2 * kw * sizeof(uint32_t);
  const int threads = n_beams >= kMaxThreads ? kMaxThreads
                                             : ((n_beams + 31) / 32) * 32;
  const dim3 block(threads);
  const dim3 grid((n_time + kSpanSamples - 1) / kSpanSamples, n_chan,
                  (n_beams + threads - 1) / threads);
#define DSABF_LAUNCH(KW, NT)                                                 \
  return int(launch<KW, NT>(grid, block, smem, st, wire, w_hi, w_lo, scales, \
                            out, n_time, n_beams, n_ant, time_stride,        \
                            chan_stride))
  switch (kw * 10 + n_terms) {
    case 41: DSABF_LAUNCH(4, 1);
    case 42: DSABF_LAUNCH(4, 2);
    case 81: DSABF_LAUNCH(8, 1);
    case 82: DSABF_LAUNCH(8, 2);
    case 161: DSABF_LAUNCH(16, 1);
    case 162: DSABF_LAUNCH(16, 2);
    default: return int(cudaErrorInvalidValue);
  }
#undef DSABF_LAUNCH
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
