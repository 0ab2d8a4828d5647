// Fused 4-bit unpack + int8 complex beamforming GEMM + power detection,
// with the optional uint8 epilogue and the incoherent and spectral-kurtosis
// side outputs, written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel launched by
//   dsabeamformer_tpu/ops/gemm.py::_fused_detect (pl.pallas_call, gemm.py:775)
// with body _detect_kernel (gemm.py:183) and _power_epilogue (gemm.py:390),
// in the int8 and int8x2 weight modes: the power product, the quant8 branch
// (gemm.py:261-278), the incoherent branch (:287-322) and the SK branch
// (:323-368), in any combination.
//
// What it computes, per channel f, output row o and beam b:
//   X[t, p, :] = [re | im] of the wire bytes of pol p, antennas 0..a_compute-1
//                (re = high nibble, im = low nibble, 4-bit two's complement)
//   M[t, p, c] = sum_k X[t, p, k] * W_term[f, k, c]      (int32, exact)
//                int8x2 combines M_hi * 256 + M_lo        (exact, |M| < 2^27)
//   out[f, o, b] = s^2 * sum_{t in o} sum_p (M[t,p,b]^2 + M[t,p,B+b]^2)
//                with M converted to f32 once and s = scales[f, n_terms-1].
// quant8 (q8_scales != null) stores instead
//   clip(rint(out[f, o, b] * q8_scales[b]), 0, 255) as uint8,
// each multiply rounded on its own, so the byte is exactly the rint/clip of
// the f32 output this kernel would store times the beam's scale.
// Side outputs, from the unpacked words the block already holds:
//   inco[f, o]     = sum_{t in o} sum_p sum_{a in inco_mask} re^2 + im^2
//                    (f32 of an exact integer below 2^24);
//   sk[f, 0, a]   += sum_{t, p} p,  sk[f, 1, a] += sum_{t, p} p^2,
//                    p = re^2 + im^2, every antenna a < a_compute
//                    (int32 per span, then one 64-bit atomicAdd per block,
//                    antenna and statistic: exact, whatever the block order).
// Only the blocks of the first beam chunk (blockIdx.z == 0) emit them, so a
// span is counted once however many beam chunks the grid has.
//
// What bounds it on an H100: integer multiply-accumulates.  One DSA-10
// block (int8x2, a_compute=32) issues 2.2e12 int8 MACs against ~1.07 GB of
// wire bytes read (only the a_compute antenna slots) and 1.07 GB of f32
// powers written (0.27 GB as uint8), about 2000 MACs per byte of device
// memory traffic, so it is far above the memory roofline.  This version
// runs the MACs as __dp4a on the CUDA cores (4 MACs per instruction), not
// on the tensor cores, so its ceiling is the dp4a instruction rate, a few
// percent of the int8 tensor-core peak; mma/wgmma s8 with TMA staging is
// later work.
// The side outputs add ~1/500 of the block's dp4a work.
//
// What the design does about it: every wire byte is read from device memory
// once and every output once; nothing else touches device memory.
//   - One thread block per (span of output rows, channel, chunk of beams).
//     Blocks are independent: no sum is carried between them (the SK sums
//     meet in integer atomics, whose order does not change the result).
//   - The block stages its span's wire bytes once into shared memory, already
//     unpacked into int8 [re | im] words (four antennas per 32-bit word, the
//     dp4a operand).  The stride arguments let one kernel read both the
//     time-major tfpa form [T, F*P*A] and the channel-major ftpa form
//     [F, T, P*A]; the corner turn happens in these loads.
//   - Each thread owns one beam: it keeps that beam's Re and Im weight
//     columns, for every term, in registers (K/4 words each) and streams the
//     span's rows out of shared memory; all threads of a warp read the same
//     row, so the loads are broadcasts.
//   - The epilogue (power, pol sum, navg_time sum, s^2, the uint8 rounding)
//     stays in registers; one coalesced store per output row.
//   - The side outputs reuse the staged words: a warp per output row sums
//     the incoherent power with __dp4a(x, x & mask); a thread per (antenna,
//     sample slice) sums p and p^2, reduced in shared memory.
//   - The output type is a template parameter (it changes the store); the
//     side outputs branch at run time on block-uniform pointers.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// Time samples staged in shared memory per block (rounded down to whole
// output rows): 256 rows * 2 pols * 16 words * 4 B = 32 KB at a_compute=32.
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

// Four mask bits (one per antenna of a word) to a byte mask: 0xFF in byte i
// when bit i is set.
__device__ __forceinline__ uint32_t byte_mask(uint32_t bits) {
  const uint32_t spread = (bits & 1u) | ((bits & 2u) << 7) |
                          ((bits & 4u) << 14) | ((bits & 8u) << 21);
  return spread * 0xFFu;
}

template <int KW, int NTERMS, typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
detect_power_kernel(const uint8_t* __restrict__ wire,
                    const int8_t* __restrict__ w_hi,
                    const int8_t* __restrict__ w_lo,
                    const float* __restrict__ scales,
                    const float* __restrict__ q8_scales,
                    OutT* __restrict__ out,
                    float* __restrict__ inco_out,
                    unsigned long long* __restrict__ sk_out,
                    uint32_t inco_mask,
                    int n_time, int n_beams, int n_ant, int navg,
                    int rows_out_per_block,
                    long long time_stride, long long chan_stride) {
  // KW = K/4 words per X row; the first AW hold re, the next AW hold im.
  constexpr int AW = KW / 2;
  constexpr int AC = 4 * AW;  // a_compute
  constexpr bool kQuant8 = std::is_same<OutT, uint8_t>::value;
  extern __shared__ __align__(16) uint32_t xs[];  // [rows][pol][KW]
  __shared__ int sk_part[2 * kMaxAnt];            // [stat][antenna]

  const int f = blockIdx.y;
  const int n_out = n_time / navg;
  const int o0 = blockIdx.x * rows_out_per_block;
  const int o_end = min(o0 + rows_out_per_block, n_out);
  const int rows = (o_end - o0) * navg;
  const bool side = blockIdx.z == 0;  // block-uniform

  // Stage: word w of (row r, pol p) <- wire bytes 4w..4w+3 of that pol.
  const uint8_t* base = wire + (long long)f * chan_stride
                        + (long long)o0 * navg * time_stride;
  for (int i = threadIdx.x; i < rows * 2 * AW; i += blockDim.x) {
    const int w = i % AW;
    const int rp = i / AW;  // r * 2 + p
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        base + (long long)(rp >> 1) * time_stride + (rp & 1) * n_ant + 4 * w);
    uint32_t* row = xs + rp * KW;
    row[w] = sign_extend_nibbles((v >> 4) & 0x0F0F0F0Fu);  // re: high nibbles
    row[AW + w] = sign_extend_nibbles(v & 0x0F0F0F0Fu);    // im: low nibbles
  }
  if (side && sk_out) {
    for (int i = threadIdx.x; i < 2 * AC; i += blockDim.x) sk_part[i] = 0;
  }

  // This thread's beam: its Re (column b) and Im (column B + b) weights,
  // packed four K rows per word so that byte i pairs with X's byte i.
  const int b = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = b < n_beams;
  const long long b2 = 2LL * n_beams;
  uint32_t wre[NTERMS][KW];
  uint32_t wim[NTERMS][KW];
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
  __syncthreads();

  // Side outputs, every thread of the block taking part (before the
  // inactive beams leave).
  if (side && inco_out) {
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int items = navg * 2 * AW;  // (sample, pol, word) of one row
    for (int o = threadIdx.x >> 5; o < o_end - o0; o += n_warps) {
      int acc = 0;
      for (int i = lane; i < items; i += 32) {
        const int w = i % AW;
        const uint32_t* row = xs + (o * navg * 2 + i / AW) * KW;
        const uint32_t m = byte_mask((inco_mask >> (4 * w)) & 0xFu);
        const uint32_t re = row[w], im = row[AW + w];
        acc = __dp4a(int(re), int(re & m), acc);
        acc = __dp4a(int(im), int(im & m), acc);
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, d);
      }
      if (lane == 0) inco_out[(long long)f * n_out + o0 + o] = float(acc);
    }
  }
  if (side && sk_out) {
    // Thread -> antenna a and every (blockDim/AC)-th (sample, pol) row.
    const int a = threadIdx.x % AC;
    const int w = a >> 2;
    const int sh = 8 * (a & 3);
    int s1 = 0, s2 = 0;  // per span: at most 768 * 128^2 < 2^31
    for (int rp = threadIdx.x / AC; rp < rows * 2; rp += blockDim.x / AC) {
      const uint32_t* row = xs + rp * KW;
      const int re = int(int8_t(uint8_t(row[w] >> sh)));
      const int im = int(int8_t(uint8_t(row[AW + w] >> sh)));
      const int p = re * re + im * im;
      s1 += p;
      s2 += p * p;
    }
    atomicAdd(&sk_part[a], s1);
    atomicAdd(&sk_part[AC + a], s2);
    __syncthreads();
    if (threadIdx.x < 2 * AC) {
      atomicAdd(sk_out + (long long)f * 2 * AC + threadIdx.x,
                (unsigned long long)sk_part[threadIdx.x]);
    }
  }
  if (!active) return;

  const float s = scales[(long long)f * NTERMS + (NTERMS - 1)];
  const float s2 = __fmul_rn(s, s);
  float qs = 0.f;
  if constexpr (kQuant8) qs = q8_scales[b];
  OutT* orow = out + ((long long)f * n_out + o0) * n_beams + b;
  for (int o = 0; o < o_end - o0; ++o) {
    float acc = 0.f;
    for (int r = o * navg; r < (o + 1) * navg; ++r) {
      float pw[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint4* x4 = reinterpret_cast<const uint4*>(xs + (r * 2 + p) * KW);
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
        int br = mre[0], bi = mim[0];
        if (NTERMS == 2) {
          // s_hi == 256 * s_lo exactly; a multiply, since a left shift of a
          // negative int is undefined in C++17.
          br = mre[0] * 256 + mre[1];
          bi = mim[0] * 256 + mim[1];
        }
        const float fr = float(br), fi = float(bi);
        // Explicit rounding: no FMA contraction, so each sample's power is
        // the plain version's to the bit; only the navg summation order can
        // differ.
        pw[p] = __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
      }
      acc = __fadd_rn(acc, __fadd_rn(pw[0], pw[1]));
    }
    const float v = __fmul_rn(acc, s2);
    if constexpr (kQuant8) {
      // rintf rounds half to even, as jnp.rint and torch.round do; the
      // clamp follows the rounding, as in gemm.py:277.
      const float c = fminf(fmaxf(rintf(__fmul_rn(v, qs)), 0.f), 255.f);
      orow[(long long)o * n_beams] = uint8_t(c);
    } else {
      orow[(long long)o * n_beams] = v;
    }
  }
}

template <int KW, int NTERMS, typename OutT>
cudaError_t launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   const void* wire, const void* w_hi, const void* w_lo,
                   const void* scales, const void* q8_scales, void* out,
                   void* inco_out, void* sk_out, uint32_t inco_mask,
                   int n_time, int n_beams, int n_ant, int navg,
                   int rows_out_per_block, long long time_stride,
                   long long chan_stride) {
  detect_power_kernel<KW, NTERMS, OutT><<<grid, block, smem, stream>>>(
      static_cast<const uint8_t*>(wire), static_cast<const int8_t*>(w_hi),
      static_cast<const int8_t*>(w_lo), static_cast<const float*>(scales),
      static_cast<const float*>(q8_scales), static_cast<OutT*>(out),
      static_cast<float*>(inco_out),
      static_cast<unsigned long long*>(sk_out), inco_mask, n_time, n_beams,
      n_ant, navg, rows_out_per_block, time_stride, chan_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// Pointers: wire uint8 (see time_stride/chan_stride), w_hi/w_lo int8
// [n_chan, 2*a_compute, 2*n_beams] (w_lo unused when n_terms == 1), scales
// f32 [n_chan, n_terms].  out is f32 [n_chan, n_time/navg, n_beams], or
// uint8 of that shape when q8_scales (f32 [n_beams]) is not null.  Optional
// (null = not computed): inco_out f32 [n_chan, n_time/navg] over the
// antennas whose bit is set in inco_mask; sk_out uint64 [n_chan, 2,
// a_compute], added to (the caller zeroes it).
int dsabf_detect_power(const void* wire, const void* w_hi, const void* w_lo,
                       const void* scales, const void* q8_scales, void* out,
                       void* inco_out, void* sk_out, unsigned int inco_mask,
                       int n_chan, int n_time, int n_beams, int n_ant,
                       int a_compute, int n_terms, int navg,
                       long long time_stride, long long chan_stride,
                       void* stream) {
  const int kw = a_compute / 2;
  if (n_chan < 1 || n_chan > 65535 || n_beams < 1 || navg < 1 ||
      n_time % navg || n_ant % 4 || a_compute % 8 || a_compute > n_ant ||
      a_compute > kMaxAnt || (n_terms != 1 && n_terms != 2)) {
    return int(cudaErrorInvalidValue);
  }
  const int rows_out = navg >= kSpanSamples ? 1 : kSpanSamples / navg;
  const size_t smem = size_t(rows_out) * navg * 2 * kw * sizeof(uint32_t);
  if (smem > kMaxStaticSmem - 2 * kMaxAnt * sizeof(int)) {
    return int(cudaErrorInvalidValue);
  }
  const int threads = n_beams >= kMaxThreads ? kMaxThreads
                                             : ((n_beams + 31) / 32) * 32;
  const dim3 block(threads);
  const dim3 grid((n_time / navg + rows_out - 1) / rows_out, n_chan,
                  (n_beams + threads - 1) / threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q8 = q8_scales != nullptr;
#define DSABF_LAUNCH(KW, NT)                                                 \
  return int(q8 ? launch<KW, NT, uint8_t>(                                  \
                      grid, block, smem, st, wire, w_hi, w_lo, scales,      \
                      q8_scales, out, inco_out, sk_out, inco_mask, n_time,  \
                      n_beams, n_ant, navg, rows_out, time_stride,          \
                      chan_stride)                                          \
                : launch<KW, NT, float>(                                    \
                      grid, block, smem, st, wire, w_hi, w_lo, scales,      \
                      q8_scales, out, inco_out, sk_out, inco_mask, n_time,  \
                      n_beams, n_ant, navg, rows_out, time_stride,          \
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
