// Unfused 4-bit unpack + int8 complex beamforming GEMM -> beam voltages,
// written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _voltage_kernel (gemm.py:427), launched by beamform_voltages
//   (pl.pallas_call, gemm.py:932), in the int8, int8x2, int12 and (through
//   beam_voltages_int13.cu) int13 weight modes; the float modes are
//   beam_voltages_float.cu.
//   The JAX wrapper's TPU-only parts stay out: the materialized tfpa corner
//   turn (this kernel reads tfpa through its strides) and shrink_tiles.
//
// What it computes, per channel f, sample t, pol p and beam b:
//   M[t, p, c] = sum_k X[t, p, k] * W_sub[f, k, c]  (int32, exact; the
//                sub-terms combined as in detect_power.cu: int8x2 M_hi * 256
//                + M_lo, int12 and int13 with 16), X = [re | im]
//   out[f, t, p, b]     = f32(M[t, p, b])     * s   (Re)
//   out[f, t, p, B + b] = f32(M[t, p, B + b]) * s   (Im)
//   s = the channel's (last) scale: one conversion and one rounded multiply,
//   so the result is the plain PyTorch version's (and the JAX kernel's) to
//   the bit.
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
//   - Staged path (a_compute 24 and 40..128; beam_voltages_staged_kernel): one
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
                     IntWeights w,
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
  load_beam_weights<KW, NTERMS>(wre, wim, w, f, b, n_beams, active);
  __syncthreads();
  if (!active) return;

  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
  const long long row = 2LL * n_beams;  // floats per (sample, pol) row
  float* o = out + ((long long)f * n_time + t0) * 2 * row + b;
  for (int rp = 0; rp < rows * 2; ++rp) {
    int br, bi;
    beam_row<KW, NTERMS>(xs + rp * KW, wre, wim, w.factor, br, bi);
    o[rp * row] = __fmul_rn(float(br), s);
    o[rp * row + n_beams] = __fmul_rn(float(bi), s);
  }
}

template <int NTERMS>
__global__ void __launch_bounds__(kStagedThreads, NTERMS == 4 ? 1 : 2)
beam_voltages_staged_kernel(const uint8_t* __restrict__ wire,
                            IntWeights w,
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
  stage_beam_weights<NTERMS>(ws, w, f, blockIdx.z * kStagedBeams, n_beams,
                             kw);
  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
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
      int m[4][n_acc(NTERMS)][2];
      staged_rows4<NTERMS>(xa, two ? xa + 2 * kw : xa, ws + lb, kw, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // rows (r, x), (r, y), (r+1, x), (r+1, y)
        if (j == 2 && !two) break;
        int br, bi;
        staged_voltage<n_acc(NTERMS)>(m, j, w.factor, br, bi);
        const long long rp = 2LL * r + j;
        o[rp * row] = __fmul_rn(float(br), s);
        o[rp * row + n_beams] = __fmul_rn(float(bi), s);
      }
    }
  }
}

template <int KW, int NTERMS>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   const void* wire, const IntWeights& w, const void* scales,
                   void* out, int n_time, int n_beams, int n_ant,
                   long long time_stride, long long chan_stride) {
  beam_voltages_kernel<KW, NTERMS><<<grid, block, smem, stream>>>(
      static_cast<const uint8_t*>(wire), w, static_cast<const float*>(scales),
      static_cast<float*>(out), n_time, n_beams, n_ant, time_stride,
      chan_stride);
  return cudaGetLastError();
}

// The staged kernel's shared memory is above the 48 KB default: raise the
// instantiation's limit to what this launch needs, then launch.
template <int NTERMS>
cudaError_t launch_staged(dim3 grid, size_t smem, cudaStream_t stream,
                          const void* wire, const IntWeights& w,
                          const void* scales, void* out, int n_time,
                          int n_beams, int n_ant, int kw,
                          long long time_stride, long long chan_stride) {
  auto kernel = beam_voltages_staged_kernel<NTERMS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, dim3(kStagedThreads), smem, stream>>>(
      static_cast<const uint8_t*>(wire), w, static_cast<const float*>(scales),
      static_cast<float*>(out), n_time, n_beams, n_ant, kw, time_stride,
      chan_stride);
  return cudaGetLastError();
}

}  // namespace

// Two libraries from this source, as detect_power.cu: one or two sub-terms
// behind dsabf_beam_voltages; four (beam_voltages_int13.cu defines
// DSABF_INT13) behind dsabf_beam_voltages_int13, whose register path ends
// at a_compute 16.
#ifdef DSABF_INT13
#define DSABF_ENTRY dsabf_beam_voltages_int13
constexpr int kRegAntLimit = 16;
#else
#define DSABF_ENTRY dsabf_beam_voltages
constexpr int kRegAntLimit = kMaxRegAnt;
#endif

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); w0, w1, n_sub, fold
// and scales as dsabf_detect_power takes them (make_int_weights,
// wire_gemm.cuh); out f32 [n_chan, n_time, 2, 2*n_beams].
// a_compute 8, 16, 32 (int13's library: 8, 16) run the register path; every
// other multiple of 8 up to 128 (24 too) the staged path, whose K is a
// run-time count; anything else is refused.
int DSABF_ENTRY(const void* wire, const void* w0, const void* w1,
                const void* scales, void* out, int n_chan, int n_time,
                int n_beams, int n_ant, int a_compute, int n_sub, int fold,
                long long time_stride, long long chan_stride, void* stream) {
  const int kw = a_compute / 2;
  IntWeights w;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || n_time < 1 ||
      n_ant % 4 || a_compute < 8 || a_compute % 8 || a_compute > n_ant ||
      a_compute > kMaxAnt ||
      !make_int_weights(w, w0, w1, n_sub, fold, a_compute, n_beams)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef DSABF_INT13
  if (n_sub != 4) return int(cudaErrorInvalidValue);
#else
  if (n_sub > 2) return int(cudaErrorInvalidValue);
#endif
  const bool reg_width = a_compute == 8 || a_compute == 16 || a_compute == 32;
  if (a_compute > kRegAntLimit || !reg_width) {
    const size_t smem = (staged_weight_words(n_sub, kw)
                         + size_t(kStagedSpan) * 2 * kw) * sizeof(uint32_t);
    const int n_spans = (n_time + kStagedSpan - 1) / kStagedSpan;
    const int chunks = (n_beams + kStagedBeams - 1) / kStagedBeams;
    const dim3 grid(staged_grid_x(n_spans, n_chan, chunks), n_chan, chunks);
#define DSABF_STAGED(NT)                                                  \
  return int(launch_staged<NT>(grid, smem, st, wire, w, scales, out,     \
                               n_time, n_beams, n_ant, kw, time_stride,  \
                               chan_stride))
#ifdef DSABF_INT13
    DSABF_STAGED(4);
#else
    if (n_sub == 1) DSABF_STAGED(1);
    DSABF_STAGED(2);
#endif
#undef DSABF_STAGED
  }
  const size_t smem = size_t(kSpanSamples) * 2 * kw * sizeof(uint32_t);
  const int threads = n_beams >= kMaxThreads ? kMaxThreads
                                             : ((n_beams + 31) / 32) * 32;
  const dim3 block(threads);
  const dim3 grid((n_time + kSpanSamples - 1) / kSpanSamples, n_chan,
                  (n_beams + threads - 1) / threads);
#define DSABF_LAUNCH(KW, NT)                                               \
  return int(launch<KW, NT>(grid, block, smem, st, wire, w, scales, out,  \
                            n_time, n_beams, n_ant, time_stride,          \
                            chan_stride))
#ifdef DSABF_INT13
  if (kw == 4) DSABF_LAUNCH(4, 4);
  DSABF_LAUNCH(8, 4);
#else
  switch (kw * 10 + n_sub) {
    case 41: DSABF_LAUNCH(4, 1);
    case 42: DSABF_LAUNCH(4, 2);
    case 81: DSABF_LAUNCH(8, 1);
    case 82: DSABF_LAUNCH(8, 2);
    case 161: DSABF_LAUNCH(16, 1);
    case 162: DSABF_LAUNCH(16, 2);
    default: return int(cudaErrorInvalidValue);
  }
#endif
#undef DSABF_LAUNCH
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
