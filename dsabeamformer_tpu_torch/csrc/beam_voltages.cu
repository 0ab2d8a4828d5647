// Unfused 4-bit unpack + complex beamforming GEMM -> beam voltages, for
// every weight mode, on the tensor cores, written by hand for Hopper
// (sm_90a).
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _voltage_kernel (gemm.py:427), launched by beamform_voltages
//   (pl.pallas_call, gemm.py:932), with its _build_x (:97) and _accumulate
//   (:121), in all seven weight modes.  The JAX wrapper's TPU-only parts stay
//   out: the materialized tfpa corner turn (this kernel reads tfpa through
//   its strides) and shrink_tiles.
//
// What it computes, per channel f, sample t, pol p and beam b:
//   int8, int8x2, int12, int13:
//   M[t, p, c] = sum_k X[t, p, k] * W_sub[f, k, c]  (int32, exact; the
//                sub-terms combined as in detect_power.cu: int8x2 M_hi * 256
//                + M_lo, int12 and int13 with 16), X = [re | im]
//   out[f, t, p, b]     = f32(M[t, p, b])     * s   (Re)
//   out[f, t, p, B + b] = f32(M[t, p, B + b]) * s   (Im)
//   s = the channel's (last) scale.  The unfolded modes' sums are 16 M
//   (mma_gemm.cuh product_scale), and f32(16 M) = 16 f32(M) exactly, so
//   f32(16 M) * 2^-4 * s, two rounded multiplies, is the plain PyTorch
//   version's (and the JAX kernel's) f32(M) * s to the bit.
//   bf16, bf16x2, f32:
//   V[t, p, c] = sum over the bf16 sub-terms and k of X * W_sub in float32
//                (bf16x2's hi and lo, f32's three exact bf16 parts), times
//                s = 1: within float32 summation order of the plain version.
//
// What bounds it on an H100: the bytes it stores.  The output is 8 bytes per
// (channel, sample, pol, beam), 16x the f32 power product: a 128-channel
// DSA-10 sub-band (a_compute 32, 256 beams, 8192 samples) stores 4.295 GB,
// 1.28 ms at 3.35 TB/s, against 6.9e10 MACs a term (0.07 ms at the dense
// int8 peak); a 128-channel DSA-110 sub-band (a_compute 128, 512 beams, 4096
// samples) the same 4.295 GB against 2.75e11 MACs a term (int8x2: 0.56 ms at
// the int8 peak; f32, three bf16 passes: 1.67 ms at the bf16 peak, which
// bounds it by operations).
//
// What the design does about it: the products leave the CUDA cores free for
// the stores.
//   - The GEMM is mma_gemm.cuh's, as in detect_power.cu: a block stages its
//     weight tile (64 beams; 32 where a bf16 tile would leave room for fewer
//     than three warpgroups: kMinGroups) once, keeps the wire bytes packed in shared memory
//     (cp.async into two buffers per warpgroup) and each warp multiplies one
//     m-tile at a time with wgmma (s8 into int32, or bf16 into float32; the
//     operand type a template parameter chosen at run time).  An m-tile is 8
//     consecutive samples of pol x (rows 0-7) and pol y (rows 8-15): the
//     geometry's output row with navg 8.  Sample slots past n_time are zero
//     rows and are not stored, so any n_time runs.
//   - Stores: a thread's fragment holds Re and Im of 16 (or 8) beams 4 apart
//     at one sample and both pols.  Stored as they are, each warp store would
//     write 16 bytes into each of 8 rows.  So each warp restages its m-tile
//     through shared memory, the Re half and then the Im half (its own 16
//     rows of a tile's width, padded so that the fragment writes meet no
//     bank twice), and writes each (sample, pol) row's half back as a whole
//     256-byte (128-byte on a 32-beam tile) segment, 16 bytes a thread, with
//     streaming stores (st.global.cs: the 4.3 GB are never read back by the
//     kernel).  Restaging one half at a time halves the rows a warp keeps,
//     which leaves room for more warpgroups.  The stores are not waited for:
//     the next m-tile's products run while they drain.
//     (Timed against it on an H100, and not kept: the whole m-tile restaged
//     at once, 2-6% slower at DSA-10 and up to 22% at DSA-110; and that with
//     cp.async.bulk stores issued by one lane a row, slower still.)
//   - Grid: beam tiles fastest, so the blocks that read the same wire span
//     (8 of them at DSA-110) run together and all but the first find it in
//     the L2 cache.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "mma_gemm.cuh"

namespace {

using namespace dsabf;

constexpr int kStageRows = 16;      // rows of an m-tile: 8 samples x 2 pols
constexpr int kMtileSamples = 8;    // samples of an m-tile
// A bf16 weight tile of 64 beams that leaves room for fewer warpgroups than
// this is 32 beams: the stores run under the other warpgroups' products, so
// more warpgroups pay for the narrower wgmma (bf16x2 at a_compute 128: two
// warpgroups on the 64-beam tile, 3.65 ms on an H100 for the 128-channel
// DSA-110 sub-band, against 3.27-3.30 ms for four on the 32-beam one).
constexpr int kMinGroups = 3;

// One m-tile's voltages, restaged through this warp's rows `stage` (Re,
// then Im) and stored to out[f, t0 .. t0 + 7, p, :] (the samples below
// n_time, the beams below n_beams): acc as tile_product left it, times
// `unit` (the product scale divided out, exact) and then the channel's
// scale s.  bt: the tile's first beam.  vec: every row's Re and Im segments
// start on 16 bytes.
template <int NT, typename Acc>
__device__ __forceinline__ void store_mtile(const Acc (&acc)[NT][4],
                                            float* stage, float unit,
                                            float s, float* out, int f,
                                            int t0, int n_time, int n_beams,
                                            int bt, bool vec, int lane) {
  constexpr int TB = 4 * NT;
  constexpr int RS = stage_stride(TB);
  constexpr int CH = TB / 4;          // float4 of a row's Re (or Im) part
  const int gq = lane >> 2;           // the fragment's sample
  const int q = lane & 3;
  const long long row = 2LL * n_beams;  // floats of an output (t, p) row
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // Re, then Im
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int pol = 0; pol < 2; ++pol) {
        const int c = 2 * pol + half;
        const float v = std::is_same<Acc, int>::value
                            ? __fmul_rn(__fmul_rn(float(acc[nt][c]), unit), s)
                            : __fmul_rn(float(acc[nt][c]), s);
        stage[(pol * kMtileSamples + gq) * RS + 4 * nt + q] = v;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kStageRows * CH / 32; ++k) {
      const int i = lane + 32 * k;
      const int r = i / CH;             // pol * 8 + sample
      const int c4 = i % CH;
      const int t = t0 + (r & 7);
      const int b = bt + 4 * c4;
      if (t < n_time && b < n_beams) {
        const float4 v =
            *reinterpret_cast<const float4*>(stage + r * RS + 4 * c4);
        float* dst = out + ((long long)f * n_time + t) * 2 * row
                     + (r >> 3) * row + half * n_beams + b;
        if (vec && b + 4 <= n_beams) {
          __stcs(reinterpret_cast<float4*>(dst), v);
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (b + j < n_beams) __stcs(dst + j, e[j]);
          }
        }
      }
    }
    __syncwarp();
  }
}

// W: the weights' operand type (IntWeights: int8 operands, int32 sums;
// FloatWeights: bf16 operands, float32 sums); NT: n-tiles of the weight
// tile (g.tile_beams / 4).
template <class W, int NT>
__global__ void __launch_bounds__(kGroupThreads * kMaxGroups, 1)
beam_voltages_kernel(const uint8_t* __restrict__ wire,
                     W w,
                     const float* __restrict__ scales,
                     float* __restrict__ out,
                     MmaGeom g, int n_time, int n_beams, int n_ant,
                     long long time_stride, long long chan_stride) {
  constexpr bool kFloat = std::is_same<W, FloatWeights>::value;
  using Acc = typename std::conditional<kFloat, float, int>::type;
  extern __shared__ __align__(128) uint8_t smem[];

  const int f = blockIdx.y;
  const int n_spans = (n_time + g.span_samples - 1) / g.span_samples;
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / kGroupThreads;
  const int warp = (threadIdx.x % kGroupThreads) >> 5;  // of the warpgroup
  const int row_lane = lane >> 2;     // the sample of an m-tile this lane holds
  const int bt = blockIdx.x * 4 * NT;

  uint8_t* ws = smem;                 // the weight tile (mma_gemm.cuh)
  const size_t raw_bytes = span_wire_bytes(g);
  // This warpgroup's two buffers of wire rows, then every warp's rows of
  // restaged voltages.
  uint8_t* raw0 = smem + weight_tile_bytes(g) + group * 2 * raw_bytes;
  float* stage = reinterpret_cast<float*>(
                     smem + weight_tile_bytes(g) + g.n_groups * 2 * raw_bytes)
                 + (group * (kGroupThreads / 32) + warp) * kStageRows
                       * stage_stride(4 * NT);

  // This warpgroup's spans: every stride-th from first.
  const int first = blockIdx.z * g.n_groups + group;
  const int stride = gridDim.z * g.n_groups;
  const uint8_t* wire_f = wire + (long long)f * chan_stride;
  // The first span's wire bytes travel while the weight tile is staged.
  if (first < n_spans) {
    const int t0 = first * g.span_samples;
    fetch_span_wire(raw0, wire_f + (long long)t0 * time_stride,
                    min(g.span_samples, n_time - t0), g, time_stride, n_ant);
  }
  stage_weight_tile<4 * NT>(ws, w, g, f, bt, n_beams);
  __syncthreads();  // ws is complete; from here the warpgroups go their ways
  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
  const float unit = kFloat ? 1.f : 1.f / float(product_scale(g.fold != 0));
  // Every segment starts on 16 bytes when the row (2B floats) and its Im
  // part (B floats further) do.
  const bool vec = n_beams % 4 == 0;
  const int plane = g.span_samples * g.raw_stride;  // pol x rows to pol y's
  const int rounds = (g.rows_out + kRoundRows - 1) / kRoundRows;

  int buf = 0;
  for (int span = first; span < n_spans; span += stride, buf ^= 1) {
    const int t0 = span * g.span_samples;
    const int here = min(g.span_samples, n_time - t0);
    const uint8_t* raw = raw0 + buf * raw_bytes;
    wait_span_wire();
    group_sync(group);  // raw is complete; the other buffer's readers are done
    const int next = span + stride;
    if (next < n_spans) {
      const int tn = next * g.span_samples;
      fetch_span_wire(raw0 + (buf ^ 1) * raw_bytes,
                      wire_f + (long long)tn * time_stride,
                      min(g.span_samples, n_time - tn), g, time_stride,
                      n_ant);
    }
    // A warp takes one m-tile of each round of kRoundRows.  Every warp
    // walks every round (the warps of a warpgroup multiply together); one
    // without samples multiplies zeros.
    for (int round = 0; round < rounds; ++round) {
      const int m0 = (round * kRoundRows + warp) * kMtileSamples;
      const int smp = m0 + row_lane;
      Acc acc[NT][4];
      tile_product(acc, raw + smp * g.raw_stride, plane, smp < here, ws, g,
                   lane);
      if (m0 < here) {
        store_mtile<NT>(acc, stage, unit, s, out, f, t0 + m0, n_time,
                        n_beams, bt, vec, lane);
      }
    }
  }
}

// The shared memory may be above the 48 KB default: raise the
// instantiation's limit to what this launch needs, then launch.
template <class W, int NT>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const void* wire, const W& w, const void* scales,
                   void* out, const MmaGeom& g, int n_time, int n_beams,
                   int n_ant, long long time_stride, long long chan_stride) {
  auto kernel = beam_voltages_kernel<W, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  // All of the SM's L1 as shared memory.
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<grid, dim3(kGroupThreads * g.n_groups), smem, stream>>>(
      static_cast<const uint8_t*>(wire), w, static_cast<const float*>(scales),
      static_cast<float*>(out), g, n_time, n_beams, n_ant, time_stride,
      chan_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); w0, w1, n_terms, fold,
// elem_size and scales as dsabf_detect_power takes them (detect_power.cu);
// out f32 [n_chan, n_time, 2, 2*n_beams], Re in columns 0 .. n_beams - 1
// and Im in n_beams .. 2*n_beams - 1.  a_compute: every multiple of 8 up to
// 128; any n_time from 1; anything else is refused.
int dsabf_beam_voltages(const void* wire, const void* w0, const void* w1,
                        const void* scales, void* out, int n_chan,
                        int n_time, int n_beams, int n_ant, int a_compute,
                        int n_terms, int fold, int elem_size,
                        long long time_stride, long long chan_stride,
                        void* stream) {
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || n_time < 1 ||
      n_ant % 4 || a_compute < 8 || a_compute % 8 || a_compute > n_ant ||
      a_compute > kMaxAnt || reinterpret_cast<uintptr_t>(out) % 16) {
    return int(cudaErrorInvalidValue);
  }
  const int n_mtiles = (n_time + kMtileSamples - 1) / kMtileSamples;
  // What every address of a wire row is a multiple of: 16 lets cp.async
  // move 16 bytes at a time.
  const bool wide = !(reinterpret_cast<uintptr_t>(wire) % 16 || n_ant % 16 ||
                      time_stride % 16 || chan_stride % 16);
  const int align = wide ? 16 : 4;
  IntWeights iw;
  FloatWeights fw;
  MmaGeom g;
  size_t smem = 0;
  int n_sub = 0;
  const bool ok =
      elem_size == 1
          ? make_int_weights(iw, w0, w1, n_terms, fold, a_compute, n_beams) &&
                make_mma_geom(g, smem, a_compute, 0, n_terms, fold, iw.factor,
                              kMtileSamples, n_mtiles, align, kMaxGroups,
                              kMinGroups, kStageRows)
          : !fold &&
                make_float_weights(fw, n_sub, w0, w1, n_terms, elem_size,
                                   a_compute, n_beams) &&
                make_mma_geom(g, smem, a_compute, 1, n_sub, 0, 1,
                              kMtileSamples, n_mtiles, align, kMaxGroups,
                              kMinGroups, kStageRows);
  if (!ok) return int(cudaErrorInvalidValue);
  const int n_spans = (n_mtiles + g.rows_out - 1) / g.rows_out;
  const int chunks = (n_beams + g.tile_beams - 1) / g.tile_beams;
  // Beam tiles fastest: the blocks that read the same wire bytes run
  // together, so all but the first find them in the L2 cache.
  const dim3 grid(chunks, n_chan,
                  staged_grid_x((n_spans + g.n_groups - 1) / g.n_groups,
                                n_chan, chunks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 1) {
    return int(launch<IntWeights, 16>(grid, smem, st, wire, iw, scales, out,
                                      g, n_time, n_beams, n_ant, time_stride,
                                      chan_stride));
  }
  if (g.tile_beams == kNarrowTileBeams) {
    return int(launch<FloatWeights, 8>(grid, smem, st, wire, fw, scales, out,
                                       g, n_time, n_beams, n_ant,
                                       time_stride, chan_stride));
  }
  return int(launch<FloatWeights, 16>(grid, smem, st, wire, fw, scales, out,
                                      g, n_time, n_beams, n_ant, time_stride,
                                      chan_stride));
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
