// Fused 4-bit unpack + float complex beamforming GEMM + detection (power or
// full Stokes) for the float weight modes (bf16, bf16x2, f32), with the
// optional uint8 epilogue and the incoherent and spectral-kurtosis side
// outputs, written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel launched by
//   dsabeamformer_tpu/ops/gemm.py::_fused_detect (pl.pallas_call, gemm.py:775)
// with body _detect_kernel (gemm.py:183), the float branch of _accumulate
// (gemm.py:146-160) and _power_epilogue (:390) or _stokes_epilogue (:402),
// with the quant8 (:261-278), incoherent (:287-322) and SK (:323-368)
// branches in any combination, for every a_compute from 8 to 128.
//
// What it computes, per channel f, output row o and beam b:
//   X[t, p, :] = [re | im] of the wire bytes of pol p (as detect_power.cu)
//   V[t, p, c] = sum over terms of (sum_k f32(X[t, p, k]) * f32(W_term[f, k,
//                c])), each K-sum in float32 in ascending k, the two bf16x2
//                partial sums added hi first (float_gemm.cuh)
//   then the detection, the scale s^2 (s = scales[f, n_terms-1], 1 for these
//   modes), the uint8 epilogue and the side outputs exactly as
//   detect_power.cu (detect_epilogue.cuh): every product and sum rounded on
//   its own, so the Stokes I plane is the power output to the bit.
//
// What bounds it on an H100: float32 multiply-adds on the CUDA cores.  One
// DSA-10 block (a_compute 32) is 1.1e12 MACs per term against ~2.2 GB of
// device memory traffic: 33 ms per term at the card's 33.5e12 float32 MAC/s
// outside the tensor cores, against 0.65 ms for the bytes.  The bf16 tensor
// cores would be 15 times faster for bf16 weights; this version does not use
// them (mma/wgmma bf16 is later work), and f32 must not (TF32 would break
// the validation mode).
//
// What the design does about it: float_gemm.cuh's staged weight tile and
// four-row inner loop.  One block per (channel, tile of 32 beams) and a share
// of the channel's spans, so a tile is staged once; 8 warps take every 8th
// output row of the span.  Blocks are independent; the SK sums meet in
// integer atomics, only the first beam tile's blocks emit side outputs.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "detect_epilogue.cuh"
#include "float_gemm.cuh"
#include "wire_gemm.cuh"

namespace {

using namespace dsabf;

template <typename WT, int NT, typename OutT, bool STOKES>
__global__ void __launch_bounds__(kFloatThreads)
detect_float_kernel(const uint8_t* __restrict__ wire,
                    const WT* __restrict__ w0, const WT* __restrict__ w1,
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
  const int k_rows = 4 * kw;            // K = 2 * a_compute
  const int ac = 2 * kw;                // a_compute
  float* ws = reinterpret_cast<float*>(smem);   // [term][col][K][beam]
  float* xf = ws + float_weight_words(NT, kw);  // [rows][pol][K]
  uint32_t* xi = reinterpret_cast<uint32_t*>(
      xf + (size_t)rows_out_per_span * navg * 2 * k_rows);  // [rows][pol][kw]

  const int f = blockIdx.y;
  const int n_out = n_time / navg;
  const int n_spans = (n_out + rows_out_per_span - 1) / rows_out_per_span;
  const bool side = blockIdx.z == 0;  // block-uniform
  const int lb = threadIdx.x % kFloatBeams;
  const int g = threadIdx.x / kFloatBeams;
  const int b = blockIdx.z * kFloatBeams + lb;
  const bool active = b < n_beams;

  stage_float_weights<WT, NT>(ws, w0, w1, f, blockIdx.z * kFloatBeams,
                              n_beams, k_rows);
  const float s = scales[(long long)f * NT + (NT - 1)];
  const float s2 = __fmul_rn(s, s);
  const float qs = std::is_same<OutT, uint8_t>::value && active
                       ? q8_scales[b] : 0.f;
  const uint8_t* wire_f = wire + (long long)f * chan_stride;

  for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
    const int o0 = span * rows_out_per_span;
    const int o_end = min(o0 + rows_out_per_span, n_out);
    const int rows = (o_end - o0) * navg;
    __syncthreads();  // the previous span's readers are done
    stage_rows(xi, wire_f + (long long)o0 * navg * time_stride, rows,
               time_stride, n_ant, kw / 2);
    if (side && sk_out) {
      for (int i = threadIdx.x; i < 2 * ac; i += blockDim.x) sk_part[i] = 0;
    }
    __syncthreads();
    rows_to_float(xf, xi, rows * 2, kw);
    if (side) {
      side_outputs(xi, kw, ac, o_end - o0, navg, inco_mask,
                   inco_out ? inco_out + (long long)f * n_out + o0 : nullptr,
                   sk_part,
                   sk_out ? sk_out + (long long)f * 2 * ac : nullptr);
    }
    __syncthreads();
    if (!active) continue;
    for (int o = o0 + g; o < o_end; o += kFloatGroups) {
      float acc[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[k] = 0.f;
      // Two samples (four rows) per step, summed in sample order.
      for (int r = 0; r < navg; r += 2) {
        const float* xa = xf + (size_t)((o - o0) * navg + r) * 2 * k_rows;
        const bool two = r + 1 < navg;
        float v[4][2];
        float_rows4<NT>(xa, two ? xa + 2 * k_rows : xa, ws + lb, k_rows, v);
#pragma unroll
        for (int smp = 0; smp < 2; ++smp) {
          if (smp == 1 && !two) break;
          const float vr[2] = {v[2 * smp][0], v[2 * smp + 1][0]};
          const float vi[2] = {v[2 * smp][1], v[2 * smp + 1][1]};
          detect_sample<STOKES>(vr, vi, acc);
        }
      }
      store_row<OutT, STOKES>(
          acc, s2, qs, out + ((long long)f * n_out + o) * NP * n_beams + b,
          n_beams);
    }
  }
}

struct Args {
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  const void *wire, *w0, *w1, *scales, *q8_scales;
  void *out, *inco_out, *sk_out;
  AntMask inco_mask;
  int n_time, n_beams, n_ant, kw, navg, rows_out;
  long long time_stride, chan_stride;
};

// The shared memory is above the 48 KB default for most widths: raise the
// instantiation's limit to what this launch needs, then launch.
template <typename WT, int NT, typename OutT, bool STOKES>
cudaError_t launch(const Args& a) {
  auto kernel = detect_float_kernel<WT, NT, OutT, STOKES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(a.smem));
  if (e != cudaSuccess) return e;
  kernel<<<a.grid, dim3(kFloatThreads), a.smem, a.stream>>>(
      static_cast<const uint8_t*>(a.wire), static_cast<const WT*>(a.w0),
      static_cast<const WT*>(a.w1), static_cast<const float*>(a.scales),
      static_cast<const float*>(a.q8_scales), static_cast<OutT*>(a.out),
      static_cast<float*>(a.inco_out),
      static_cast<unsigned long long*>(a.sk_out), a.inco_mask, a.n_time,
      a.n_beams, a.n_ant, a.kw, a.navg, a.rows_out, a.time_stride,
      a.chan_stride);
  return cudaGetLastError();
}

template <typename WT, int NT>
cudaError_t dispatch(const Args& a, bool stokes) {
  const bool q8 = a.q8_scales != nullptr;
  if (stokes) {
    return q8 ? launch<WT, NT, uint8_t, true>(a)
              : launch<WT, NT, float, true>(a);
  }
  return q8 ? launch<WT, NT, uint8_t, false>(a)
            : launch<WT, NT, float, false>(a);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); w0, w1 the weight
// terms [n_chan, 2*a_compute, 2*n_beams] of elem_size 4 (float32, n_terms 1)
// or 2 (bfloat16, n_terms 1 or 2; w1 unused when n_terms == 1); scales f32
// [n_chan, n_terms].  out, q8_scales, inco_out, inco_mask and sk_out as
// dsabf_detect_power takes them.  a_compute: any multiple of 8 up to 128.
int dsabf_detect_float(const void* wire, const void* w0, const void* w1,
                       const void* scales, const void* q8_scales, void* out,
                       void* inco_out, void* sk_out,
                       const unsigned int* inco_mask, int n_chan, int n_time,
                       int n_beams, int n_ant, int a_compute, int n_terms,
                       int elem_size, int navg, int stokes,
                       long long time_stride, long long chan_stride,
                       void* stream) {
  const int kw = a_compute / 2;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || navg < 1 ||
      n_time < navg || n_time % navg || n_ant % 4 || a_compute < 8 ||
      a_compute % 8 || a_compute > n_ant || a_compute > kMaxAnt ||
      (inco_out && !inco_mask) ||
      !((elem_size == 4 && n_terms == 1) ||
        (elem_size == 2 && (n_terms == 1 || n_terms == 2)))) {
    return int(cudaErrorInvalidValue);
  }
  Args a;
  const int n_out = n_time / navg;
  const int samples = float_span_samples(kw, n_terms, navg,
                                         kFloatGroups * navg);
  if (samples == 0) return int(cudaErrorInvalidValue);
  a.rows_out = samples / navg;
  a.smem = float_weight_words(n_terms, kw) * sizeof(float)
           + size_t(a.rows_out) * navg * float_sample_bytes(kw);
  const int n_spans = (n_out + a.rows_out - 1) / a.rows_out;
  const int chunks = (n_beams + kFloatBeams - 1) / kFloatBeams;
  a.grid = dim3(staged_grid_x(n_spans, n_chan, chunks), n_chan, chunks);
  a.stream = static_cast<cudaStream_t>(stream);
  a.wire = wire;
  a.w0 = w0;
  a.w1 = w1;
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
  if (elem_size == 4) return int(dispatch<float, 1>(a, st));
  return int(n_terms == 1 ? dispatch<uint16_t, 1>(a, st)
                          : dispatch<uint16_t, 2>(a, st));
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
