// The unpack and GEMM of the voltage kernels (beam_voltages.cu): the JAX
// package's _build_x and _accumulate (dsabeamformer_tpu/ops/gemm.py:97-145)
// for the int8 weight modes (int8, int8x2, int12, int13), as __dp4a on the
// CUDA cores; and what every int8 kernel shares: the weight operand
// (IntWeights), the nibble unpack, the incoherent mask.  The detect kernel's
// GEMM runs on the tensor cores (mma_gemm.cuh); the float modes' GEMM is
// float_gemm.cuh.
//
// A mode is a set of 1, 2 or 4 int8 sub-terms [2 * a_compute, 2B] per
// channel (IntWeights) and a combine factor:
//   int8    one sub-term;
//   int8x2  two tensors, M_hi * 256 + M_lo;
//   int12   one tensor [[hi], [lo]] along K, M_hi * 16 + M_lo;
//   int13   one tensor [[h1], [l1], [h2], [l2]], (M_h1 + M_h2) * 16 +
//           (M_l1 + M_l2): h1 + h2 does not fit int8, so all four stay,
//           but the even and the odd sub-terms share an accumulator.
// The JAX kernel folds the 16 into its data operand ([16X | X], K = 4a or
// 8a); here the [re | im] rows staged once are multiplied by every
// sub-term and the factor is applied to the int32 sums: the same integer.
//
//   - stage_rows: a block stages its span's wire bytes once into shared
//     memory, already unpacked into int8 [re | im] words (four antennas per
//     32-bit word, the dp4a operand).  Row rp = 2 * sample + pol.  The
//     stride arguments let one kernel read both the time-major tfpa form
//     [T, F*P*A] and the channel-major ftpa form [F, T, P*A]; the corner
//     turn happens in these loads.
//
// Two ways to hold the weights, chosen by a_compute alone:
//
//   - The register path (a_compute 8, 16, 32): load_beam_weights gives each
//     thread one beam and keeps that beam's Re (column b) and Im (column
//     B + b) weight columns, for every term, in registers (K/4 words each);
//     beam_row multiplies one staged row by them.  All threads of a warp
//     read the same row, so the X loads are broadcasts.
//   - The staged path (every other multiple of 8 up to 128): at K = 256
//     one beam's int8x2 columns are 2 terms x 2 columns x 64 words = 256
//     registers, past the 255 a thread has, so a block stages a tile of
//     kStagedBeams beams' columns, every term, into shared memory
//     (stage_beam_weights), laid out [term][re|im][K word][beam]: the 32
//     threads of a warp (32 consecutive beams) read 32 consecutive words,
//     one per bank.  K is a run-time word count.  staged_rows4 multiplies
//     four staged rows (both pols of two samples) at once, so each weight
//     word loaded from shared memory feeds four __dp4a: one load per dp4a
//     would bound the loop by shared-memory issue at about half the dp4a
//     rate.
//
// Both paths give the integer Re and Im of the beam voltage, exact: one
// sub-term's |M| <= K * 8 * 127 = 260,096 < 2^18 at K = 2 * a_compute = 256,
// and int8x2's M_hi * 256 + M_lo < 2^27, int13's 17 * 2 * 260,096 < 2^24
// stay inside int32.  The caller converts it to float32 once (rounding
// above 2^24, as XLA's m.astype(f32), JAX gemm.py:145, and the plain
// version's int64 -> float32 do).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace dsabf {

// Register path: time samples staged in shared memory per block: 256
// samples * 2 pols * 16 words * 4 B = 32 KB at a_compute=32.
constexpr int kSpanSamples = 256;
constexpr int kMaxThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;
constexpr int kMaxRegAnt = 32;  // a_compute of the largest register kernel

// Staged path: a block is kStagedGroups groups of kStagedBeams threads, one
// beam each; group g takes every kStagedGroups-th output row (or sample
// pair) of the span, all groups share the staged weights.  At a_compute 128
// a two-sub-term weight tile (int8x2, int12) is 64 KB and a 64-sample span
// 32 KB, so two blocks (512 threads) fit on an SM and one's staging hides
// behind the other's dp4a work; int13's four sub-terms are 128 KB, one
// block per SM.
constexpr int kStagedBeams = 64;
constexpr int kStagedGroups = 4;
constexpr int kStagedThreads = kStagedBeams * kStagedGroups;
constexpr int kStagedSpan = 64;
constexpr int kMaxAnt = 128;                // largest a_compute of any path
constexpr int kMaxDynSmem = 227 * 1024;     // per block on an H100

// The incoherent sum's antenna selection: bit a of word a / 32.
struct AntMask {
  uint32_t w[kMaxAnt / 32];
};

// Four 4-bit two's-complement values, one in the low nibble of each byte,
// to four int8 values.  (n & 8) * 0x1E is 0xF0 in every byte whose nibble
// is negative and cannot carry into the next byte.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t n) {
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// Stage `rows` samples (both pols) starting at `base` into xs
// [rows][pol][2 * aw]: word w of (sample r, pol p) <- wire bytes 4w..4w+3 of
// that pol; the first aw words hold re, the next aw im.  (The register
// kernels pass a compile-time aw, which the inlined divisions fold.)
__device__ __forceinline__ void stage_rows(uint32_t* xs, const uint8_t* base,
                                           int rows, long long time_stride,
                                           int n_ant, int aw) {
  const int kw = 2 * aw;
  for (int i = threadIdx.x; i < rows * 2 * aw; i += blockDim.x) {
    const int w = i % aw;
    const int rp = i / aw;  // r * 2 + p
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        base + (long long)(rp >> 1) * time_stride + (rp & 1) * n_ant + 4 * w);
    uint32_t* row = xs + rp * kw;
    row[w] = sign_extend_nibbles((v >> 4) & 0x0F0F0F0Fu);  // re: high nibbles
    row[aw + w] = sign_extend_nibbles(v & 0x0F0F0F0Fu);    // im: low nibbles
  }
}

// The int8 sub-terms of a weight mode (by value to the kernels): sub-term t
// of channel f starts at sub[t] + f * chan_stride and is [2 * a_compute,
// 2 * n_beams]; `factor` combines the hi and lo sums; the channel's scale is
// scales[f * n_scales + n_scales - 1].
constexpr int kMaxSubTerms = 4;
struct IntWeights {
  const int8_t* sub[kMaxSubTerms];
  long long chan_stride;
  int factor;
  int n_scales;
};

// Fill an IntWeights from the C interface's arguments: `fold` == 0 takes
// n_sub (1 or 2) separate tensors w0, w1 (int8, int8x2: factor 256, a scale
// per tensor); `fold` != 0 takes n_sub (2 or 4) sub-terms stacked along K
// in the one tensor w0 (int12, int13: factor 16, one scale).
inline bool make_int_weights(IntWeights& w, const void* w0, const void* w1,
                             int n_sub, int fold, int a_compute,
                             int n_beams) {
  const long long sub_elems = 2LL * a_compute * 2 * n_beams;
  if (fold ? (n_sub != 2 && n_sub != 4) : (n_sub != 1 && n_sub != 2)) {
    return false;
  }
  for (int t = 0; t < kMaxSubTerms; ++t) {
    const int8_t* base = static_cast<const int8_t*>(fold || t == 0 ? w0 : w1);
    w.sub[t] = t < n_sub ? base + (fold ? t * sub_elems : 0) : nullptr;
  }
  w.chan_stride = fold ? n_sub * sub_elems : sub_elems;
  w.factor = fold ? 16 : 256;
  w.n_scales = fold ? 1 : n_sub;
  return true;
}

// Sub-term t's pointer by selects (no dynamically indexed copy of the
// by-value parameter in local memory).
__device__ __forceinline__ const int8_t* sub_term(const IntWeights& w, int t) {
  static_assert(kMaxSubTerms == 4, "sub_term selects among four pointers");
  return t == 0 ? w.sub[0] : t == 1 ? w.sub[1] : t == 2 ? w.sub[2] : w.sub[3];
}

// Accumulators per output: sub-term t adds into t % n_acc(NTERMS) (hi sums
// in 0, lo sums in 1; a single term in 0).
__host__ __device__ constexpr int n_acc(int nterms) {
  return nterms < 2 ? 1 : 2;
}

// hi and lo sums combine as M_hi * factor + M_lo (int8x2: s_hi == 256 *
// s_lo exactly; the folded modes: 16).  A multiply, since a left shift of a
// negative int is undefined in C++17.
template <int NACC>
__device__ __forceinline__ int combine_terms(const int (&m)[NACC],
                                             int factor) {
  return NACC == 2 ? m[0] * factor + m[NACC - 1] : m[0];
}

// ----------------------------- register path ----------------------------

// Beam b's Re and Im weight columns of channel f, every term, packed four
// K rows per word so that byte i pairs with X's byte i (zeros when the
// thread has no beam).  Sub-terms are int8 [4*KW, 2*n_beams] per channel.
template <int KW, int NTERMS>
__device__ __forceinline__ void load_beam_weights(
    uint32_t (&wre)[NTERMS][KW], uint32_t (&wim)[NTERMS][KW],
    const IntWeights& w, int f, int b, int n_beams, bool active) {
  const long long b2 = 2LL * n_beams;
#pragma unroll
  for (int term = 0; term < NTERMS; ++term) {
    const int8_t* wt = w.sub[term] + (long long)f * w.chan_stride;
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
                                         int factor, int& br, int& bi) {
  constexpr int NACC = n_acc(NTERMS);
  const uint4* x4 = reinterpret_cast<const uint4*>(xrow);
  int mre[NACC], mim[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) mre[a] = mim[a] = 0;
#pragma unroll
  for (int q = 0; q < KW / 4; ++q) {
    const uint4 x = x4[q];
    const int xw[4] = {int(x.x), int(x.y), int(x.z), int(x.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int term = 0; term < NTERMS; ++term) {
        mre[term % NACC] =
            __dp4a(xw[e], int(wre[term][4 * q + e]), mre[term % NACC]);
        mim[term % NACC] =
            __dp4a(xw[e], int(wim[term][4 * q + e]), mim[term % NACC]);
      }
    }
  }
  br = combine_terms<NACC>(mre, factor);
  bi = combine_terms<NACC>(mim, factor);
}

// ------------------------------ staged path -----------------------------

// Shared memory of a staged block: the weight tile, then the span's rows.
__host__ __device__ constexpr size_t staged_weight_words(int nterms, int kw) {
  return size_t(nterms) * 2 * kw * kStagedBeams;
}

// gridDim.x of a staged launch: enough blocks (n_chan * chunks * x) for a
// few waves of two per SM, each block walking every x-th span.
inline int staged_grid_x(int n_spans, int n_chan, int chunks) {
  const int want = (2048 + n_chan * chunks - 1) / (n_chan * chunks);
  return want < n_spans ? want : n_spans;
}

// The weight tile of beams b0 .. b0 + kStagedBeams - 1 of channel f into
// ws [term][col][kw][kStagedBeams] (col 0 = Re column b, 1 = Im column
// B + b): word q of (term, col, beam) packs K rows 4q..4q+3, byte i with
// X's byte i; zeros for beams past n_beams.  Consecutive threads take
// consecutive beams, so each byte load of a warp is one 32-byte segment.
template <int NTERMS>
__device__ __forceinline__ void stage_beam_weights(
    uint32_t* ws, const IntWeights& w, int f, int b0, int n_beams, int kw) {
  const long long b2 = 2LL * n_beams;
  const int total = int(staged_weight_words(NTERMS, kw));
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int b = b0 + i % kStagedBeams;
    const int row = i / kStagedBeams;  // (term * 2 + col) * kw + q
    const int q = row % kw;
    const int tc = row / kw;
    uint32_t v = 0;
    if (b < n_beams) {
      const int8_t* wt = sub_term(w, tc >> 1) + (long long)f * w.chan_stride
                         + (long long)(4 * q) * b2 + (tc & 1) * n_beams + b;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v |= uint32_t(uint8_t(wt[k * b2])) << (8 * k);
      }
    }
    ws[i] = v;
  }
}

__device__ __forceinline__ int word_of(const uint4& x, int e) {
  return int(e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w);
}

// Four staged rows -- xa, xa + kw (sample A, pols x and y) and xb, xb + kw
// (sample B) -- times this thread's beam's staged columns (wb = ws + the
// beam's index in the tile).  m[row][acc][col], acc = term % n_acc, col 0
// Re, 1 Im.
template <int NTERMS>
__device__ __forceinline__ void staged_rows4(
    const uint32_t* xa, const uint32_t* xb, const uint32_t* wb, int kw,
    int (&m)[4][n_acc(NTERMS)][2]) {
  constexpr int NACC = n_acc(NTERMS);
  const uint4* xr[4] = {reinterpret_cast<const uint4*>(xa),
                        reinterpret_cast<const uint4*>(xa + kw),
                        reinterpret_cast<const uint4*>(xb),
                        reinterpret_cast<const uint4*>(xb + kw)};
  const int plane = kw * kStagedBeams;  // words between (term, col) planes
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int ac = 0; ac < 2 * NACC; ++ac) m[r][ac >> 1][ac & 1] = 0;
  }
  for (int q4 = 0; q4 < kw / 4; ++q4) {
    uint4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = xr[r][q4];
    const uint32_t* wq = wb + q4 * 4 * kStagedBeams;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int tc = 0; tc < 2 * NTERMS; ++tc) {
        const int w = int(wq[tc * plane + e * kStagedBeams]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          m[r][(tc >> 1) % NACC][tc & 1] =
              __dp4a(word_of(x[r], e), w, m[r][(tc >> 1) % NACC][tc & 1]);
        }
      }
    }
  }
}

// Row r (0..3) of staged_rows4's result: the beam voltage's integer Re, Im.
template <int NACC>
__device__ __forceinline__ void staged_voltage(const int (&m)[4][NACC][2],
                                               int r, int factor, int& br,
                                               int& bi) {
  int re[NACC], im[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    re[t] = m[r][t][0];
    im[t] = m[r][t][1];
  }
  br = combine_terms<NACC>(re, factor);
  bi = combine_terms<NACC>(im, factor);
}

}  // namespace dsabf
