// Fused 4-bit unpack + complex beamforming GEMM + detection (power or full
// Stokes), with the optional uint8 epilogue and the incoherent and
// spectral-kurtosis side outputs, for every weight mode, written by hand for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel launched by
//   dsabeamformer_tpu/ops/gemm.py::_fused_detect (pl.pallas_call, gemm.py:775)
// with body _detect_kernel (gemm.py:183), its _accumulate (:146-160), and
// _power_epilogue (gemm.py:390) or _stokes_epilogue (gemm.py:402, via
// beamform_stokes :795), in all seven weight modes: the power and Stokes
// products, the quant8 branch (gemm.py:261-278, Stokes offset :266-274),
// the incoherent branch (:287-322) and the SK branch (:323-368), in any
// combination, for every a_compute that is a multiple of 8 up to 128
// (DSA-110: 110 active antennas in 128 slots, 512 beams), on the tensor
// cores (wgmma s8 for the int8 modes, wgmma bf16 for the float ones).
//
// What it computes, per channel f, output row o and beam b:
//   X[t, p, :] = [re | im] of the wire bytes of pol p, antennas 0..a_compute-1
//                (re = high nibble, im = low nibble, 4-bit two's complement)
//   int8, int8x2, int12, int13:
//   M[t, p, c] = sum_k X[t, p, k] * W_sub[f, k, c]       (int32, exact)
//                int8x2 combines M_hi * 256 + M_lo        (exact, |M| < 2^27)
//                int12  M_hi * 16 + M_lo, int13 (M_h1 + M_h2) * 16 + M_l1 +
//                M_l2: the JAX kernel's [16X | X] operand against its one
//                term, without staging the 16x planes (mma_gemm.cuh)
//                converted to f32 once;
//   bf16, bf16x2, f32:
//   V[t, p, c] = sum over sub-terms and k of X[t, p, k] * W_sub[f, k, c]
//                in float32: bf16's one term, bf16x2's hi and lo, f32's
//                three bf16 parts (w = w1 + w2 + w3 exactly, mma_gemm.cuh
//                split_f32).  Every product of a 4-bit voltage and a bf16 is
//                exact in float32, so only the order of the float32 sums
//                separates V from the plain version's;
//   then, with x = pol 0, y = pol 1, r = column b, i = column B + b and s =
//   the channel's (last) scale (1 for the float modes):
//   power:  out[f, o, b]    = s^2 * sum_{t in o} (px + py),
//           px = xr^2 + xi^2, py = yr^2 + yi^2
//   Stokes: out[f, o, k, b] = s^2 * sum_{t in o} of, for k = I, Q, U, V,
//           px + py, px - py, cr + cr, ci + ci,
//           cr = xr*yr + xi*yi = Re(Bx By*), ci = xi*yr - xr*yi = Im(Bx By*)
//   Every product and sum is rounded on its own (__fmul_rn / __fadd_rn),
//   so nvcc contracts nothing: the Stokes I plane is the power output to
//   the bit (the same sum in the same order).
// quant8 (q8_scales != null) stores instead
//   clip(rint(out * q8_scales[b] + off), 0, 255) as uint8, off = 0 for power
//   and I, kQuvOffset for Q/U/V; the multiply and the offset are rounded
//   once (__fmaf_rn), as XLA contracts the JAX kernel's on the CPU, so the
//   byte is exactly the rint/clip of the f32 output this kernel would store.
// Side outputs, from the packed wire bytes the block already holds (no
// weight mode changes them):
//   inco[f, o]     = sum_{t in o} sum_p sum_{a in inco_mask} re^2 + im^2
//                    (f32 of an exact integer below 2^24; the mask is 128
//                    bits, four words);
//   sk[f, 0, a]   += sum_{t, p} p,  sk[f, 1, a] += sum_{t, p} p^2,
//                    p = re^2 + im^2, every antenna a < a_compute
//                    (int32 per span, then one 64-bit atomicAdd per span,
//                    antenna and statistic: exact, whatever the block order).
// Only the blocks of the first beam tile (blockIdx.x == 0) emit them, so a
// span is counted once however many beam chunks the grid has.
//
// What bounds it on an H100: operations, the multiply-accumulates and the
// detection that follows them.  One DSA-10 block (int8x2, a_compute 32) is
// 2.2e12 int8 MACs (bf16: 1.1e12 bf16 MACs a term, f32 three bf16 terms)
// against ~1.07 GB of wire bytes read (only the a_compute antenna slots) and
// 1.07 GB of f32 powers written (0.27 GB as uint8; the Stokes product is 4x
// both), about 2000 (500 for Stokes) MACs per byte of device memory
// traffic; a DSA-110 block (a_compute 128, 512 beams) 8.8e12 MACs against
// ~3.2 GB, so both are far above the memory roofline.  The GEMM's result is
// never stored: 16 samples x 2 pols x (Re, Im) collapse into one float32 per
// beam and output row, which costs the CUDA cores two multiplies and two
// adds (int8: and two conversions) per (sample, pol, beam) and is, at K =
// 64, of the same order as the tensor cores' time.  f32 on the CUDA cores'
// fmaf would be bound at 33.5e12 MAC/s; as three bf16 passes it is bound at
// a third of the bf16 rate, 4.9 times less time, and a float32 weight never
// meets TF32, which keeps 10 of its 23 mantissa bits.
//
// What the design does about it:
//   - The products run on the tensor cores as wgmma (mma_gemm.cuh: s8
//     m64n128k32, or bf16 m64n128k16 with float32 sums; A from registers, B
//     from shared memory), and the operand layouts are chosen so that one
//     thread's accumulator fragment is xr, xi, yr, yi of one (sample, beam):
//     detection starts from the registers the product ended in, with no
//     exchange between threads.
//   - Nothing is unpacked into memory.  In the chosen K order a thread's A
//     fragment is the re and im nibbles of one wire word (bf16: one half of
//     one) per row, so the wire bytes stay packed in shared memory and each
//     thread makes its fragment with two loads and a few logic operations
//     per step (bf16: and one fma.rn.bf16x2 a register, which turns the
//     biased nibble into its value exactly, with no table).
//   - The weight operand type is a template parameter (IntWeights or
//     FloatWeights), chosen at run time from the mode: the float modes share
//     every other part of the kernel with the int8 ones.
//   - One block per (channel, tile of 64 beams) and a share of the
//     channel's spans: the tile's weight columns are staged (turned K-major,
//     f32's split into three bf16) once and serve every span the block
//     walks.  f32's tile at a_compute 112 and 128 (three 64 KB parts) would
//     leave room for one warpgroup's rows, whose detection would leave the
//     tensor cores idle; there the tile is 32 beams (m64n64k16), so that two
//     or more warpgroups share it (make_mma_geom).
//   - A warpgroup is the unit of work.  Its four warps take four output
//     rows at a time (one m-tile each per step, the tile's beams wide), it
//     walks its own spans with its own two wire buffers (cp.async brings
//     the next span while this one multiplies) and its own barrier, and it
//     shares only the weight tile with the block's other warpgroups (up to
//     four; two for Stokes, whose running sums take the registers): while
//     one detects, the others' products keep the tensor cores busy.
//   - A span's wire bytes are scattered 32-byte pieces of the time-major
//     block, and every beam tile needs them again: the beam tiles of a
//     channel are neighbours in the grid, so the first brings them into the
//     L2 cache for the others.
//   - K is walked in steps of 32 bytes (int8: 16 antennas, the tail
//     zero-filled; bf16: 8 antennas), so every a_compute that is a multiple
//     of 8 runs the same kernel; the sub-terms of a mode share one set of
//     accumulators (mma_gemm.cuh).
//   - The samples of an output row sit in different lanes of a warp; the
//     sum over them is a butterfly of shuffles per plane that leaves each
//     lane with one or two beams' sums, four neighbouring lanes with four
//     neighbouring beams.
//   - Blocks are independent: no sum is carried between them (the SK sums
//     meet in integer atomics, whose order does not change the result).
//   - The side outputs read the staged wire bytes: a warp per output row
//     sums the incoherent power of the masked antennas (masked_power,
//     detect_epilogue.cuh); threads per (antenna, row slice) sum p and p^2,
//     reduced in shared memory.
//   - The operand type, the tile width, the output type and the product are
//     template parameters; the weight mode, a_compute and navg are run-time
//     values, so the library is twelve kernels (int8: 4; bf16: 4 of each
//     tile width).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "detect_epilogue.cuh"
#include "mma_gemm.cuh"

namespace {

using namespace dsabf;

// The side outputs of the span whose wire bytes fetch_span_wire brought into
// raw (n_rows_out output rows): the incoherent sums into inco_row[0 ..
// n_rows_out) and the SK sums added to sk_chan[2 * a_compute] (either pointer
// null = not computed; both uniform).  Called by the threads of warpgroup
// `group` (tid: the thread's rank in it); sk_part [2 * a_compute] is the
// warpgroup's, must be zero, and raw complete (a group_sync) before the call.
__device__ __forceinline__ void side_outputs_wire(
    const uint8_t* raw, const MmaGeom& g, int n_rows_out, const AntMask& mask,
    float* inco_row, int* sk_part, unsigned long long* sk_chan, int group,
    int tid) {
  const int aw = g.a_compute / 4;
  if (inco_row) {
    const int lane = tid & 31;
    const int n_warps = kGroupThreads >> 5;
    const int items = g.navg * aw;  // (sample, wire word) of one row and pol
    for (int o = tid >> 5; o < n_rows_out; o += n_warps) {
      int acc = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint8_t* rows = raw + (p * g.span_samples + o * g.navg)
                                        * g.raw_stride;
        for (int i = lane; i < items; i += 32) {
          const int smp = fast_div(i, g.words);
          const int q = i - smp * aw;
          const uint32_t v = *reinterpret_cast<const uint32_t*>(
              rows + smp * g.raw_stride + 4 * q);
          const uint32_t m = byte_mask((mask_word(mask, q >> 3)
                                        >> (4 * (q & 7))) & 0xFu);
          acc = masked_power(sign_extend_nibbles((v >> 4) & 0x0F0F0F0Fu),
                             sign_extend_nibbles(v & 0x0F0F0F0Fu), m, acc);
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, d);
      }
      if (lane == 0) inco_row[o] = float(acc);
    }
  }
  if (sk_chan) {
    // `per` threads per antenna, each taking every per-th (pol, sample) row;
    // the threads past per * ac sit out.  Per span an antenna sums at most
    // 2^13 values of p <= 128 (p^2 <= 2^14): the span's rows (at least 16
    // bytes each, in two buffers) fit in 227 KB, so S2 < 2^27 and int32 is
    // exact.
    const int ac = g.a_compute;
    const int per = kGroupThreads / ac;
    const int samples = n_rows_out * g.navg;
    if (tid < per * ac) {
      const int a = tid % ac;
      int s1 = 0, s2 = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint8_t* col = raw + p * g.span_samples * g.raw_stride + a;
        for (int r = tid / ac; r < samples; r += per) {
          const uint32_t v = col[r * g.raw_stride];
          const int re = int(int8_t(v)) >> 4;           // high nibble, signed
          const int im = int(int8_t(uint8_t(v << 4))) >> 4;  // low nibble
          const int pw = re * re + im * im;
          s1 += pw;
          s2 += pw * pw;
        }
      }
      atomicAdd(&sk_part[a], s1);
      atomicAdd(&sk_part[ac + a], s2);
    }
    group_sync(group);
    for (int i = tid; i < 2 * ac; i += kGroupThreads) {
      atomicAdd(sk_chan + i, (unsigned long long)sk_part[i]);
    }
  }
}

// One step of sum_row_lanes: the lanes whose row-lane index g has bit B set
// keep n-tiles H .. 2H - 1 and send 0 .. H - 1 to their partner (the lane
// 4 * B away), the others the reverse; each adds what it receives.
template <int H, int B, int NT, int NP>
__device__ __forceinline__ void fold_row_lanes(float (&v)[NT][NP], int g) {
  const bool up = (g & B) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float send = up ? v[i][k] : v[i + H][k];
      const float keep = up ? v[i + H][k] : v[i][k];
      v[i][k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4 * B));
    }
  }
}

// The sums of one output row, held as v[n-tile][plane] with the row's
// samples spread over the eight row-lanes (lane / 4) of the warp: a butterfly
// in which each step halves the n-tiles a lane keeps, so that lane l ends
// with the whole sums of n-tiles NT / 8 * (l / 4) + j, j < NT / 8, in v[j],
// i.e. of beams 4 * that + l % 4 (NT 16: two beams, NT 8: one).  The same
// adds in the same order for every plane.
template <int NT, int NP>
__device__ __forceinline__ void sum_row_lanes(float (&v)[NT][NP], int lane) {
  static_assert(NT == 16 || NT == 8, "three steps leave NT / 8 of NT");
  fold_row_lanes<NT / 2, 4>(v, lane >> 2);
  fold_row_lanes<NT / 4, 2>(v, lane >> 2);
  fold_row_lanes<NT / 8, 1>(v, lane >> 2);
}

// One m-tile's accumulators (eight samples, both pols, the tile's beams)
// detected and added to the running sums of its output row.
template <bool STOKES, int NT, typename Acc>
__device__ __forceinline__ void detect_tile(
    const Acc (&acc)[NT][4], float (&run)[NT][STOKES ? 4 : 1]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float vr[2] = {float(acc[nt][0]), float(acc[nt][2])};
    const float vi[2] = {float(acc[nt][1]), float(acc[nt][3])};
    detect_sample<STOKES>(vr, vi, run[nt]);
  }
}

// The most warpgroups of a block: the power product's kernels keep to 128
// registers a thread, the Stokes epilogue's running sums (four planes for
// each of sixteen n-tiles) need about twice that.
__host__ __device__ constexpr int max_groups(bool stokes) {
  return stokes ? 2 : kMaxGroups;
}

// W: the weights' operand type (IntWeights: int8 operands, int32 sums;
// FloatWeights: bf16 operands, float32 sums); NT: n-tiles of the weight
// tile (g.tile_beams / 4).
template <class W, int NT, typename OutT, bool STOKES>
__global__ void __launch_bounds__(kGroupThreads * max_groups(STOKES), 1)
detect_mma_kernel(const uint8_t* __restrict__ wire,
                  W w,
                  const float* __restrict__ scales,
                  const float* __restrict__ q8_scales,
                  OutT* __restrict__ out,
                  float* __restrict__ inco_out,
                  unsigned long long* __restrict__ sk_out,
                  AntMask inco_mask, MmaGeom g,
                  int n_time, int n_beams, int n_ant,
                  long long time_stride, long long chan_stride) {
  constexpr int NP = STOKES ? 4 : 1;
  constexpr bool kFloat = std::is_same<W, FloatWeights>::value;
  constexpr int kKept = NT / 8;  // n-tiles a lane stores (sum_row_lanes)
  using Acc = typename std::conditional<kFloat, float, int>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int sk_parts[max_groups(STOKES)][2 * kMaxAnt];  // [stat][antenna]

  const int f = blockIdx.y;
  const int n_out = n_time / g.navg;
  const int n_spans = (n_out + g.rows_out - 1) / g.rows_out;
  const bool side = blockIdx.x == 0;  // block-uniform
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int warp = tid >> 5;          // of the warpgroup
  const int row_lane = lane >> 2;     // the sample of an m-tile this lane holds
  // After sum_row_lanes: this lane's beams, 4 apart.
  const int b0 = blockIdx.x * 4 * NT + 4 * kKept * row_lane + (lane & 3);

  uint8_t* ws = smem;                   // the weight tile (mma_gemm.cuh)
  const size_t raw_bytes = span_wire_bytes(g);
  // This warpgroup's two buffers of wire rows.
  uint8_t* raw0 = smem + weight_tile_bytes(g) + group * 2 * raw_bytes;
  int* sk_part = sk_parts[group];

  // This warpgroup's spans: every stride-th from first.
  const int first = blockIdx.z * g.n_groups + group;
  const int stride = gridDim.z * g.n_groups;
  const uint8_t* wire_f = wire + (long long)f * chan_stride;
  // The first span's wire bytes travel while the weight tile is staged.
  if (first < n_spans) {
    fetch_span_wire(
        raw0, wire_f + (long long)first * g.rows_out * g.navg * time_stride,
        min(g.rows_out, n_out - first * g.rows_out) * g.navg, g, time_stride,
        n_ant);
  }
  stage_weight_tile<4 * NT>(ws, w, g, f, blockIdx.x * 4 * NT, n_beams);
  __syncthreads();  // ws is complete; from here the warpgroups go their ways
  const float s = scales[(long long)f * w.n_scales + (w.n_scales - 1)];
  // The int8 voltages come as product_scale times M, the detected sums as
  // its square times theirs: a power of two, so every rounding on the way is
  // the one M's would have had, and dividing it out here is exact.  The
  // bf16 products are the voltages themselves.
  const int ps = kFloat ? 1 : product_scale(g.fold != 0);
  const float s2 = __fmul_rn(__fmul_rn(s, s), 1.f / float(ps * ps));
  float qs[kKept];
#pragma unroll
  for (int j = 0; j < kKept; ++j) {
    qs[j] = std::is_same<OutT, uint8_t>::value && b0 + 4 * j < n_beams
                ? q8_scales[b0 + 4 * j] : 0.f;
  }
  const int plane = g.span_samples * g.raw_stride;  // pol x rows to pol y's
  const int rounds = (g.rows_out + kRoundRows - 1) / kRoundRows;

  int buf = 0;
  for (int span = first; span < n_spans; span += stride, buf ^= 1) {
    const int o0 = span * g.rows_out;
    const int rows_here = min(g.rows_out, n_out - o0);
    const uint8_t* raw = raw0 + buf * raw_bytes;
    wait_span_wire();
    group_sync(group);  // raw is complete; the other buffer's readers are done
    const int next = span + stride;
    if (next < n_spans) {
      fetch_span_wire(
          raw0 + (buf ^ 1) * raw_bytes,
          wire_f + (long long)next * g.rows_out * g.navg * time_stride,
          min(g.rows_out, n_out - next * g.rows_out) * g.navg, g,
          time_stride, n_ant);
    }
    if (side) {
      if (sk_out) {
        for (int i = tid; i < 2 * g.a_compute; i += kGroupThreads) {
          sk_part[i] = 0;
        }
        group_sync(group);
      }
      side_outputs_wire(
          raw, g, rows_here, inco_mask,
          inco_out ? inco_out + (long long)f * n_out + o0 : nullptr, sk_part,
          sk_out ? sk_out + (long long)f * 2 * g.a_compute : nullptr, group,
          tid);
    }

    // A warp takes one output row of each round of kRoundRows, its m-tiles
    // one after the other.  Every warp walks every m-tile (the warps of a
    // warpgroup multiply together); one without a row multiplies zeros.
    for (int round = 0; round < rounds; ++round) {
      const int o = round * kRoundRows + warp;
      const bool row_live = o < rows_here;
      float run[NT][NP];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int k = 0; k < NP; ++k) run[nt][k] = 0.f;
      }
      for (int j = 0; j < g.mpr; ++j) {
        const int smp = 8 * j + row_lane;  // of the output row's navg
        Acc acc[NT][4];
        tile_product(acc, raw + (o * g.navg + smp) * g.raw_stride, plane,
                     row_live && smp < g.navg, ws, g, lane);
        if (row_live) detect_tile<STOKES>(acc, run);
      }
      if (!row_live) continue;
      sum_row_lanes(run, lane);
      OutT* dst = out + ((long long)f * n_out + o0 + o) * NP * n_beams;
#pragma unroll
      for (int j = 0; j < kKept; ++j) {
        const int b = b0 + 4 * j;
        if (b < n_beams) {
          store_row<OutT, STOKES>(run[j], s2, qs[j], dst + b, n_beams);
        }
      }
    }
  }
}

// --------------------------------- launch --------------------------------

struct Args {
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  IntWeights iw;    // the weights, as the operand type reads them
  FloatWeights fw;
  MmaGeom g;
  const void *wire, *scales, *q8_scales;
  void *out, *inco_out, *sk_out;
  AntMask inco_mask;
  int n_time, n_beams, n_ant;
  long long time_stride, chan_stride;
};

template <class W>
const W& weights_of(const Args& a);
template <>
const IntWeights& weights_of<IntWeights>(const Args& a) {
  return a.iw;
}
template <>
const FloatWeights& weights_of<FloatWeights>(const Args& a) {
  return a.fw;
}

// The shared memory may be above the 48 KB default: raise the
// instantiation's limit to what this launch needs, then launch.
template <class W, int NT, typename OutT, bool STOKES>
cudaError_t launch(const Args& a) {
  auto kernel = detect_mma_kernel<W, NT, OutT, STOKES>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(a.smem));
  if (e != cudaSuccess) return e;
  // All of the SM's L1 as shared memory.
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<a.grid, dim3(kGroupThreads * a.g.n_groups), a.smem, a.stream>>>(
      static_cast<const uint8_t*>(a.wire),
      weights_of<W>(a),
      static_cast<const float*>(a.scales),
      static_cast<const float*>(a.q8_scales), static_cast<OutT*>(a.out),
      static_cast<float*>(a.inco_out),
      static_cast<unsigned long long*>(a.sk_out), a.inco_mask, a.g, a.n_time,
      a.n_beams, a.n_ant, a.time_stride, a.chan_stride);
  return cudaGetLastError();
}

// The instantiation for the output type and the product.
template <class W, int NT>
cudaError_t dispatch(const Args& a, bool stokes) {
  const bool q8 = a.q8_scales != nullptr;
  if (stokes) {
    return q8 ? launch<W, NT, uint8_t, true>(a) : launch<W, NT, float, true>(a);
  }
  return q8 ? launch<W, NT, uint8_t, false>(a) : launch<W, NT, float, false>(a);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride); the weights as
// elem_size says:
//   1  int8, as make_int_weights (wire_gemm.cuh) takes them: fold == 0,
//      n_terms (1 or 2) tensors w0, w1 [n_chan, 2*a_compute, 2*n_beams] (w1
//      unused when n_terms == 1) and scales f32 [n_chan, n_terms]; fold !=
//      0, one tensor w0 [n_chan, n_terms*2*a_compute, 2*n_beams] of n_terms
//      (2 or 4) sub-terms and scales f32 [n_chan, 1];
//   2  bfloat16, n_terms (1 or 2) tensors w0, w1 [n_chan, 2*a_compute,
//      2*n_beams] and scales f32 [n_chan, n_terms];
//   4  float32, one tensor w0 of that shape and scales f32 [n_chan, 1].
// out is f32 [n_chan, n_time/navg, n_beams] (stokes == 0) or
// [n_chan, n_time/navg, 4, n_beams] (stokes != 0: I, Q, U, V), or uint8 of
// that shape when q8_scales (f32 [n_beams]) is not null.
// Optional (null = not computed): inco_out f32 [n_chan, n_time/navg] over
// the antennas whose bit is set in inco_mask (host memory, kMaxAnt / 32
// words, bit a of word a / 32; read before this returns); sk_out uint64
// [n_chan, 2, a_compute], added to (the caller zeroes it).
// a_compute: every multiple of 8 up to 128; anything else is refused, and
// so is a navg whose output row does not fit in shared memory beside the
// weight tile.
int dsabf_detect_power(const void* wire, const void* w0, const void* w1,
                       const void* scales, const void* q8_scales, void* out,
                       void* inco_out, void* sk_out,
                       const unsigned int* inco_mask, int n_chan, int n_time,
                       int n_beams, int n_ant, int a_compute, int n_terms,
                       int fold, int elem_size, int navg, int stokes,
                       long long time_stride, long long chan_stride,
                       void* stream) {
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || navg < 1 ||
      n_time < navg || n_time % navg || n_ant % 4 || a_compute < 8 ||
      a_compute % 8 || a_compute > n_ant || a_compute > kMaxAnt ||
      (inco_out && !inco_mask)) {
    return int(cudaErrorInvalidValue);
  }
  const int n_out = n_time / navg;
  // What every address of a wire row is a multiple of: 16 lets cp.async
  // move 16 bytes at a time.
  const bool wide = !(reinterpret_cast<uintptr_t>(wire) % 16 || n_ant % 16 ||
                      time_stride % 16 || chan_stride % 16);
  const int align = wide ? 16 : 4;
  const int groups = max_groups(stokes != 0);
  Args a;
  int n_sub = 0;
  const bool ok =
      elem_size == 1
          ? make_int_weights(a.iw, w0, w1, n_terms, fold, a_compute,
                             n_beams) &&
                make_mma_geom(a.g, a.smem, a_compute, 0, n_terms, fold,
                              a.iw.factor, navg, n_out, align, groups, 2,
                              0)
          : !fold &&
                make_float_weights(a.fw, n_sub, w0, w1, n_terms, elem_size,
                                   a_compute, n_beams) &&
                make_mma_geom(a.g, a.smem, a_compute, 1, n_sub, 0, 1, navg,
                              n_out, align, groups, 2, 0);
  if (!ok) return int(cudaErrorInvalidValue);
  const int n_spans = (n_out + a.g.rows_out - 1) / a.g.rows_out;
  const int chunks = (n_beams + a.g.tile_beams - 1) / a.g.tile_beams;
  // Beam tiles fastest: the blocks that read the same wire bytes run
  // together, so all but the first find them in the L2 cache.
  a.grid = dim3(chunks, n_chan,
                staged_grid_x((n_spans + a.g.n_groups - 1) / a.g.n_groups,
                              n_chan, chunks));
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
  a.time_stride = time_stride;
  a.chan_stride = chan_stride;
  const bool st = stokes != 0;
  if (elem_size == 1) return int(dispatch<IntWeights, 16>(a, st));
  if (a.g.tile_beams == kNarrowTileBeams) {
    return int(dispatch<FloatWeights, 8>(a, st));
  }
  return int(dispatch<FloatWeights, 16>(a, st));
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
