// Fused 4-bit unpack + int8 complex beamforming GEMM + detection (power or
// full Stokes), with the optional uint8 epilogue and the incoherent and
// spectral-kurtosis side outputs, written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel launched by
//   dsabeamformer_tpu/ops/gemm.py::_fused_detect (pl.pallas_call, gemm.py:775)
// with body _detect_kernel (gemm.py:183) and _power_epilogue (gemm.py:390)
// or _stokes_epilogue (gemm.py:402, via beamform_stokes :795), in the int8,
// int8x2, int12 and (through detect_power_int13.cu) int13 weight modes; the
// float modes are detect_float.cu.  The power and Stokes products, the
// quant8 branch (gemm.py:261-278, Stokes offset :266-274), the incoherent
// branch (:287-322) and the SK branch (:323-368), in any combination, for
// any a_compute the TPU kernel takes up to 128 (DSA-110: 110 active antennas
// in 128 slots, 512 beams).
//
// What it computes, per channel f, output row o and beam b:
//   X[t, p, :] = [re | im] of the wire bytes of pol p, antennas 0..a_compute-1
//                (re = high nibble, im = low nibble, 4-bit two's complement)
//   M[t, p, c] = sum_k X[t, p, k] * W_sub[f, k, c]       (int32, exact)
//                int8x2 combines M_hi * 256 + M_lo        (exact, |M| < 2^27)
//                int12  M_hi * 16 + M_lo, int13 (M_h1 + M_h2) * 16 + M_l1 +
//                M_l2: the JAX kernel's [16X | X] operand against its one
//                term, without staging the 16x planes (wire_gemm.cuh)
//   with M converted to f32 once (x = pol 0, y = pol 1, r = column b,
//   i = column B + b) and s = the channel's (last) scale:
//   power:  out[f, o, b]    = s^2 * sum_{t in o} (px + py),
//           px = xr^2 + xi^2, py = yr^2 + yi^2
//   Stokes: out[f, o, k, b] = s^2 * sum_{t in o} of, for k = I, Q, U, V,
//           px + py, px - py, cr + cr, ci + ci,
//           cr = xr*yr + xi*yi = Re(Bx By*), ci = xi*yr - xr*yi = Im(Bx By*)
//   Every product and sum is rounded on its own (__fmul_rn / __fadd_rn),
//   so nvcc contracts nothing: the Stokes I plane is the power output to
//   the bit (the same sum in the same order), on either weight path.
// quant8 (q8_scales != null) stores instead
//   clip(rint(out * q8_scales[b] + off), 0, 255) as uint8, off = 0 for power
//   and I, kQuvOffset for Q/U/V; the multiply and the offset are rounded
//   once (__fmaf_rn), as XLA contracts the JAX kernel's on the CPU, so the
//   byte is exactly the rint/clip of the f32 output this kernel would store.
// Side outputs, from the unpacked words the block already holds:
//   inco[f, o]     = sum_{t in o} sum_p sum_{a in inco_mask} re^2 + im^2
//                    (f32 of an exact integer below 2^24; the mask is 128
//                    bits, four words);
//   sk[f, 0, a]   += sum_{t, p} p,  sk[f, 1, a] += sum_{t, p} p^2,
//                    p = re^2 + im^2, every antenna a < a_compute
//                    (int32 per span, then one 64-bit atomicAdd per span,
//                    antenna and statistic: exact, whatever the block order).
// Only the blocks of the first beam chunk (blockIdx.z == 0) emit them, so a
// span is counted once however many beam chunks the grid has.
//
// What bounds it on an H100: integer multiply-accumulates.  One DSA-10
// block (int8x2, a_compute=32) issues 2.2e12 int8 MACs against ~1.07 GB of
// wire bytes read (only the a_compute antenna slots) and 1.07 GB of f32
// powers written (0.27 GB as uint8; the Stokes product is 4x both), about
// 2000 (500 for Stokes) MACs per byte of device memory traffic; a DSA-110
// block (a_compute 128, 512 beams) 8.8e12 MACs against ~3.2 GB, so both are
// far above the memory roofline.  This version runs the MACs as __dp4a on
// the CUDA cores (4 MACs per instruction), not on the tensor cores, so its
// ceiling is the dp4a instruction rate, a few percent of the int8
// tensor-core peak; mma/wgmma s8 with TMA staging is later work.
// The side outputs add ~1/500 of the block's dp4a work, the Stokes epilogue
// a few float operations per sample and beam.
//
// What the design does about it: every wire byte is read from device memory
// once per beam chunk and every output once; nothing else touches device
// memory.
//   - The register path (a_compute 8, 16, 32; detect_power_kernel): one
//     thread block per (span of output rows, channel, chunk of up to 256
//     beams), a thread per beam with its weight columns in registers.
//   - The staged path (a_compute 40..128; detect_staged_kernel): one block
//     per (channel, chunk of 64 beams) and a share of the block's spans;
//     the beam tile's weight columns are staged into shared memory once and
//     serve every span the block walks; 4 groups of 64 threads take every
//     4th output row of a 64-sample span, each weight word feeding 4 rows.
//   - Blocks are independent: no sum is carried between them (the SK sums
//     meet in integer atomics, whose order does not change the result).
//   - The unpack into shared memory and the dp4a products are
//     wire_gemm.cuh's; detection, stores and side outputs
//     detect_epilogue.cuh's.
//   - The epilogue (detection, pol sum, navg_time sum, s^2, the uint8
//     rounding) stays in registers; one coalesced store per output row and
//     plane (Stokes: four, the planes of [F, T', 4, B]).
//   - The side outputs reuse the staged words: a warp per output row sums
//     the incoherent power with __dp4a(x, x & mask); threads per (antenna,
//     sample slice) sum p and p^2, reduced in shared memory.
//   - The output type and the product are template parameters (they change
//     the stores and the epilogue's registers); the side outputs branch at
//     run time on block-uniform pointers.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "detect_epilogue.cuh"
#include "wire_gemm.cuh"

namespace {

using namespace dsabf;

// ----------------------------- register path ----------------------------

template <int KW, int NTERMS, typename OutT, bool STOKES>
__global__ void __launch_bounds__(kMaxThreads)
detect_power_kernel(const uint8_t* __restrict__ wire,
                    IntWeights w,
                    const float* __restrict__ scales,
                    const float* __restrict__ q8_scales,
                    OutT* __restrict__ out,
                    float* __restrict__ inco_out,
                    unsigned long long* __restrict__ sk_out,
                    AntMask inco_mask,
                    int n_time, int n_beams, int n_ant, int navg,
                    int rows_out_per_block,
                    long long time_stride, long long chan_stride) {
  // KW = K/4 words per X row; the first AW hold re, the next AW hold im.
  constexpr int AW = KW / 2;
  constexpr int AC = 4 * AW;  // a_compute
  constexpr int NP = STOKES ? 4 : 1;  // output planes
  extern __shared__ __align__(16) uint32_t xs[];  // [rows][pol][KW]
  __shared__ int sk_part[2 * kMaxRegAnt];         // [stat][antenna]

  const int f = blockIdx.y;
  const int n_out = n_time / navg;
  const int o0 = blockIdx.x * rows_out_per_block;
  const int o_end = min(o0 + rows_out_per_block, n_out);
  const bool side = blockIdx.z == 0;  // block-uniform

  stage_rows(xs, wire + (long long)f * chan_stride
                     + (long long)o0 * navg * time_stride,
             (o_end - o0) * navg, time_stride, n_ant, AW);
  if (side && sk_out) {
    for (int i = threadIdx.x; i < 2 * AC; i += blockDim.x) sk_part[i] = 0;
  }

  const int b = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = b < n_beams;
  uint32_t wre[NTERMS][KW];
  uint32_t wim[NTERMS][KW];
  load_beam_weights<KW, NTERMS>(wre, wim, w, f, b, n_beams, active);
  __syncthreads();

  // Side outputs, every thread of the block taking part (before the
  // inactive beams leave).
  if (side) {
    side_outputs(xs, KW, AC, o_end - o0, navg, inco_mask,
                 inco_out ? inco_out + (long long)f * n_out + o0 : nullptr,
                 sk_part,
                 sk_out ? sk_out + (long long)f * 2 * AC : nullptr);
  }
  if (!active) return;

  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
  const float s2 = __fmul_rn(s, s);
  const float qs = std::is_same<OutT, uint8_t>::value ? q8_scales[b] : 0.f;
  OutT* orow = out + ((long long)f * n_out + o0) * NP * n_beams + b;
  for (int o = 0; o < o_end - o0; ++o) {
    float acc[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[k] = 0.f;
    for (int r = o * navg; r < (o + 1) * navg; ++r) {
      float vr[2], vi[2];  // Re, Im of the beam voltage of pol x (0), y (1)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        int br, bi;
        beam_row<KW, NTERMS>(xs + (r * 2 + p) * KW, wre, wim, w.factor, br,
                             bi);
        vr[p] = float(br);
        vi[p] = float(bi);
      }
      detect_sample<STOKES>(vr, vi, acc);
    }
    store_row<OutT, STOKES>(acc, s2, qs, orow + (long long)o * NP * n_beams,
                            n_beams);
  }
}

// ------------------------------ staged path -----------------------------

// Two blocks per SM, except with int13's four sub-terms, whose 128 KB weight
// tile at a_compute 128 leaves room for one.
template <int NTERMS, typename OutT, bool STOKES>
__global__ void __launch_bounds__(kStagedThreads, NTERMS == 4 ? 1 : 2)
detect_staged_kernel(const uint8_t* __restrict__ wire,
                     IntWeights w,
                     const float* __restrict__ scales,
                     const float* __restrict__ q8_scales,
                     OutT* __restrict__ out,
                     float* __restrict__ inco_out,
                     unsigned long long* __restrict__ sk_out,
                     AntMask inco_mask,
                     int n_time, int n_beams, int n_ant, int kw, int navg,
                     int rows_out_per_span,
                     long long time_stride, long long chan_stride) {
  constexpr int NP = STOKES ? 4 : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int sk_part[2 * kMaxAnt];  // [stat][antenna]
  uint32_t* ws = smem;                  // [term][col][kw][kStagedBeams]
  uint32_t* xs = smem + staged_weight_words(NTERMS, kw);  // [rows][pol][kw]

  const int f = blockIdx.y;
  const int ac = 2 * kw;  // a_compute
  const int n_out = n_time / navg;
  const int n_spans = (n_out + rows_out_per_span - 1) / rows_out_per_span;
  const bool side = blockIdx.z == 0;  // block-uniform
  const int lb = threadIdx.x % kStagedBeams;
  const int g = threadIdx.x / kStagedBeams;
  const int b = blockIdx.z * kStagedBeams + lb;
  const bool active = b < n_beams;

  stage_beam_weights<NTERMS>(ws, w, f, blockIdx.z * kStagedBeams, n_beams,
                             kw);
  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
  const float s2 = __fmul_rn(s, s);
  const float qs = std::is_same<OutT, uint8_t>::value && active
                       ? q8_scales[b] : 0.f;
  const uint8_t* wire_f = wire + (long long)f * chan_stride;

  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    const int o0 = span * rows_out_per_span;
    const int o_end = min(o0 + rows_out_per_span, n_out);
    __syncthreads();  // the previous span's readers are done
    stage_rows(xs, wire_f + (long long)o0 * navg * time_stride,
               (o_end - o0) * navg, time_stride, n_ant, kw / 2);
    if (side && sk_out) {
      for (int i = threadIdx.x; i < 2 * ac; i += blockDim.x) sk_part[i] = 0;
    }
    __syncthreads();
    if (side) {
      side_outputs(xs, kw, ac, o_end - o0, navg, inco_mask,
                   inco_out ? inco_out + (long long)f * n_out + o0 : nullptr,
                   sk_part,
                   sk_out ? sk_out + (long long)f * 2 * ac : nullptr);
    }
    if (!active) continue;
    for (int o = o0 + g; o < o_end; o += kStagedGroups) {
      float acc[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[k] = 0.f;
      // Two samples (four rows) per step, summed in sample order.
      for (int r = 0; r < navg; r += 2) {
        const uint32_t* xa = xs + ((o - o0) * navg + r) * 2 * kw;
        const bool two = r + 1 < navg;
        int m[4][n_acc(NTERMS)][2];
        staged_rows4<NTERMS>(xa, two ? xa + 2 * kw : xa, ws + lb, kw, m);
#pragma unroll
        for (int smp = 0; smp < 2; ++smp) {
          if (smp == 1 && !two) break;
          float vr[2], vi[2];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            int br, bi;
            staged_voltage<n_acc(NTERMS)>(m, 2 * smp + p, w.factor, br, bi);
            vr[p] = float(br);
            vi[p] = float(bi);
          }
          detect_sample<STOKES>(vr, vi, acc);
        }
      }
      store_row<OutT, STOKES>(
          acc, s2, qs, out + ((long long)f * n_out + o) * NP * n_beams + b,
          n_beams);
    }
  }
}

// --------------------------------- launch --------------------------------

struct Args {
  dim3 grid, block;
  size_t smem;
  cudaStream_t stream;
  IntWeights w;
  const void *wire, *scales, *q8_scales;
  void *out, *inco_out, *sk_out;
  AntMask inco_mask;
  int n_time, n_beams, n_ant, kw, navg, rows_out;
  long long time_stride, chan_stride;
};

template <int KW, int NTERMS, typename OutT, bool STOKES>
cudaError_t launch(const Args& a) {
  detect_power_kernel<KW, NTERMS, OutT, STOKES>
      <<<a.grid, a.block, a.smem, a.stream>>>(
          static_cast<const uint8_t*>(a.wire), a.w,
          static_cast<const float*>(a.scales),
          static_cast<const float*>(a.q8_scales), static_cast<OutT*>(a.out),
          static_cast<float*>(a.inco_out),
          static_cast<unsigned long long*>(a.sk_out), a.inco_mask, a.n_time,
          a.n_beams, a.n_ant, a.navg, a.rows_out, a.time_stride,
          a.chan_stride);
  return cudaGetLastError();
}

// The staged kernels' shared memory is above the 48 KB default: raise the
// instantiation's limit to what this launch needs, then launch.
template <int NTERMS, typename OutT, bool STOKES>
cudaError_t launch_staged(const Args& a) {
  auto kernel = detect_staged_kernel<NTERMS, OutT, STOKES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(a.smem));
  if (e != cudaSuccess) return e;
  kernel<<<a.grid, a.block, a.smem, a.stream>>>(
      static_cast<const uint8_t*>(a.wire), a.w,
      static_cast<const float*>(a.scales),
      static_cast<const float*>(a.q8_scales), static_cast<OutT*>(a.out),
      static_cast<float*>(a.inco_out),
      static_cast<unsigned long long*>(a.sk_out), a.inco_mask, a.n_time,
      a.n_beams, a.n_ant, a.kw, a.navg, a.rows_out, a.time_stride,
      a.chan_stride);
  return cudaGetLastError();
}

template <int KW, int NTERMS>
cudaError_t dispatch(const Args& a, bool stokes) {
  const bool q8 = a.q8_scales != nullptr;
  if (stokes) {
    return q8 ? launch<KW, NTERMS, uint8_t, true>(a)
              : launch<KW, NTERMS, float, true>(a);
  }
  return q8 ? launch<KW, NTERMS, uint8_t, false>(a)
            : launch<KW, NTERMS, float, false>(a);
}

template <int NTERMS>
cudaError_t dispatch_staged(const Args& a, bool stokes) {
  const bool q8 = a.q8_scales != nullptr;
  if (stokes) {
    return q8 ? launch_staged<NTERMS, uint8_t, true>(a)
              : launch_staged<NTERMS, float, true>(a);
  }
  return q8 ? launch_staged<NTERMS, uint8_t, false>(a)
            : launch_staged<NTERMS, float, false>(a);
}

}  // namespace

// This source builds two libraries, so that two compilers run side by side:
// as it stands, the kernels of one or two sub-terms (int8, int8x2, int12)
// behind dsabf_detect_power; included by detect_power_int13.cu, which
// defines DSABF_INT13, those of four sub-terms behind
// dsabf_detect_power_int13.  With four sub-terms a beam's columns fill the
// registers at a_compute 16 already (4 x 2 x 8 = 64 words, as int8x2 at 32),
// so a_compute 32 takes the staged path there.
#ifdef DSABF_INT13
#define DSABF_ENTRY dsabf_detect_power_int13
constexpr int kRegAntLimit = 16;
#else
#define DSABF_ENTRY dsabf_detect_power
constexpr int kRegAntLimit = kMaxRegAnt;
#endif

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); the int8 weights as
// make_int_weights (wire_gemm.cuh) takes them: fold == 0, n_sub (1 or 2)
// tensors w0, w1 [n_chan, 2*a_compute, 2*n_beams] (w1 unused when n_sub ==
// 1) and scales f32 [n_chan, n_sub]; fold != 0, one tensor w0 [n_chan,
// n_sub*2*a_compute, 2*n_beams] of n_sub (2 or 4) sub-terms and scales f32
// [n_chan, 1].  This library takes n_sub 1 and 2 (int13's: 4).  out is f32
// [n_chan, n_time/navg, n_beams] (stokes == 0) or [n_chan, n_time/navg, 4,
// n_beams] (stokes != 0: I, Q, U, V), or uint8 of that shape when q8_scales
// (f32 [n_beams]) is not null.
// Optional (null = not computed): inco_out f32 [n_chan, n_time/navg] over
// the antennas whose bit is set in inco_mask (host memory, kMaxAnt / 32
// words, bit a of word a / 32; read before this returns); sk_out uint64
// [n_chan, 2, a_compute], added to (the caller zeroes it).
// a_compute 8, 16, 32 (int13's library: 8, 16) run the register path;
// above that to 128 in steps of 8 the staged path; anything else is refused.
int DSABF_ENTRY(const void* wire, const void* w0, const void* w1,
                const void* scales, const void* q8_scales, void* out,
                void* inco_out, void* sk_out, const unsigned int* inco_mask,
                int n_chan, int n_time, int n_beams, int n_ant, int a_compute,
                int n_sub, int fold, int navg, int stokes,
                long long time_stride, long long chan_stride, void* stream) {
  const int kw = a_compute / 2;
  const bool staged = a_compute > kRegAntLimit;
  Args a;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || navg < 1 ||
      n_time < navg || n_time % navg || n_ant % 4 || a_compute < 8 ||
      a_compute % 8 || a_compute > n_ant || a_compute > kMaxAnt ||
      (inco_out && !inco_mask) ||
      !make_int_weights(a.w, w0, w1, n_sub, fold, a_compute, n_beams)) {
    return int(cudaErrorInvalidValue);
  }
  const int n_out = n_time / navg;
  if (staged) {
    a.rows_out = navg >= kStagedSpan ? 1 : kStagedSpan / navg;
    a.smem = (staged_weight_words(n_sub, kw)
              + size_t(a.rows_out) * navg * 2 * kw) * sizeof(uint32_t);
    if (a.smem > kMaxDynSmem - 2 * kMaxAnt * sizeof(int)) {
      return int(cudaErrorInvalidValue);
    }
    const int n_spans = (n_out + a.rows_out - 1) / a.rows_out;
    const int chunks = (n_beams + kStagedBeams - 1) / kStagedBeams;
    a.block = dim3(kStagedThreads);
    a.grid = dim3(staged_grid_x(n_spans, n_chan, chunks), n_chan, chunks);
  } else {
    a.rows_out = navg >= kSpanSamples ? 1 : kSpanSamples / navg;
    a.smem = size_t(a.rows_out) * navg * 2 * kw * sizeof(uint32_t);
    if (a.smem > kMaxStaticSmem - 2 * kMaxRegAnt * sizeof(int)) {
      return int(cudaErrorInvalidValue);
    }
    const int threads = n_beams >= kMaxThreads ? kMaxThreads
                                               : ((n_beams + 31) / 32) * 32;
    a.block = dim3(threads);
    a.grid = dim3((n_out + a.rows_out - 1) / a.rows_out, n_chan,
                  (n_beams + threads - 1) / threads);
  }
  a.stream = static_cast<cudaStream_t>(stream);
  a.wire = wire;
  a.scales = scales;
  a.q8_scales = q8_scales;
  a.out = out;
  a.inco_out = inco_out;
  a.sk_out = sk_out;
  for (int i = 0; i < kMaxAnt / 32; ++i) {
    a.inco_mask.w[i] = inco_mask ? inco_mask[i] : 0u;
  }
  a.n_time = n_time;
  a.n_beams = n_beams;
  a.n_ant = n_ant;
  a.kw = kw;
  a.navg = navg;
  a.time_stride = time_stride;
  a.chan_stride = chan_stride;
  const bool st = stokes != 0;
#ifdef DSABF_INT13
  if (n_sub != 4) return int(cudaErrorInvalidValue);
  if (staged) return int(dispatch_staged<4>(a, st));
  return int(kw == 4 ? dispatch<4, 4>(a, st) : dispatch<8, 4>(a, st));
#else
  if (n_sub > 2) return int(cudaErrorInvalidValue);
  if (staged) {
    return int(n_sub == 1 ? dispatch_staged<1>(a, st)
                          : dispatch_staged<2>(a, st));
  }
  switch (kw * 10 + n_sub) {
    case 41: return int(dispatch<4, 1>(a, st));
    case 42: return int(dispatch<4, 2>(a, st));
    case 81: return int(dispatch<8, 1>(a, st));
    case 82: return int(dispatch<8, 2>(a, st));
    case 161: return int(dispatch<16, 1>(a, st));
    case 162: return int(dispatch<16, 2>(a, st));
    default: return int(cudaErrorInvalidValue);
  }
#endif
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
