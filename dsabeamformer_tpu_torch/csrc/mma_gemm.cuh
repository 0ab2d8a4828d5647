// The beamforming GEMM on the tensor cores: the JAX package's _unpack_tile /
// _build_x / _accumulate (dsabeamformer_tpu/ops/gemm.py:73-160) for every
// weight mode, with one of two operand types:
//   int8 (int8, int8x2, int12, int13)
//     wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8
//   bf16 (bf16, bf16x2, and f32 as three bf16 parts)
//     wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16, N = 128 or 64
// (one warpgroup: A from registers, B from shared memory through a matrix
// descriptor).  detect_power.cu and beam_voltages.cu are built on it; the
// GEMM ends in a warp's registers and what follows (detection, or the
// voltages' restaged stores) is the caller's.
//
// The layouts are chosen so that the accumulator fragment of one thread is
// already one detection operand, and so that nothing is unpacked twice:
//
//   K order   int8: a wire word (four antennas of one pol and sample)
//             unpacks into one re word and one im word.  A k32 step is [re of
//             16 antennas | im of the same 16]; sub-term t's steps follow
//             sub-term t - 1's.  An a_compute that is no multiple of 16
//             zero-fills the tail of its last step in X and in W, so every
//             multiple of 8 up to kMaxAnt runs the same code.
//             bf16: a k16 step is [re of 8 antennas | im of the same 8], so
//             every multiple of 8 fills its steps exactly.  Both are 32 bytes
//             of a weight column, so the tile's layout and its descriptor are
//             the same in bytes for the two types.
//   A         int8: in that K order the A fragment of a thread (rows g and
//             g + 8, K bytes 4q .. 4q + 3 and 16 + 4q .. of a step) is the re
//             and the im nibbles of ONE wire word per row.  bf16: the
//             fragment (K elements 2q, 2q + 1 and 8 + 2q, 9 + 2q) is the re
//             and the im nibbles of one 16-bit half of a wire word per row,
//             each nibble made a bf16 in registers (nibbles_bf16).  So the
//             wire bytes stay packed in shared memory, as cp.async brought
//             them, and a thread makes its fragment with two loads and a few
//             logic operations; no unpacked copy of X exists anywhere.
//   Rows      An m-tile (16 rows) is pol x of eight samples in rows 0-7 and
//             pol y of the same samples in rows 8-15: c0..c3 of a fragment
//             are xr, xi, yr, yi of one (sample, beam).  An output row of
//             navg samples is ceil(navg / 8) m-tiles, which one warp takes
//             one after the other; sample slots past navg are zero rows
//             (they add 0 to every sum), so any navg runs.  The voltage
//             kernel's output row is one m-tile (navg 8) of its own.
//   Columns   A block's weight tile holds tile_beams (64, or 32 for a float
//             tile too large for two warpgroups' rows beside it) beams as
//             columns Re_b, Im_b, Re_b+1, Im_b+1, ... (columns b and B + b of
//             the [K, 2B] term), K-major per column: c0, c1 of a fragment are
//             Re and Im of one beam.  In shared memory the tile is the matrix
//             descriptor's canonical K-major layout without swizzle: core
//             matrices of 8 columns x 16 K bytes, 128 contiguous bytes each,
//             the core matrices of one 8-column group one after the other
//             along K (leading byte offset 128), the groups 8 * K bytes
//             apart (stride byte offset).
//   Sub-terms share one accumulator: int8x2 multiplies the int32 sums of the
//             hi term by 256 before the lo term's steps add on top; the
//             folded modes feed 16 X against the hi sub-terms and X against
//             the lo ones, the JAX kernel's [16X | X] operand: 16 re is the
//             wire byte's high nibble where it stands (& 0xF0), 16 im the
//             low nibble shifted up, two operations a register where the
//             sign extension of X takes five.  So int8 and int8x2, which
//             need no X beside it, multiply 16 X throughout and end with 16
//             M (product_scale; the caller divides it out, exactly, with its
//             own power-of-two factor).  M stays below 2^27 (wire_gemm.cuh),
//             16 M below 2^31.  The bf16 sub-terms (bf16x2's hi and lo, f32's
//             three parts) add their products into the same float32 sums,
//             step by step: one fragment of X serves every sub-term's step.
//   Staging   A span's wire bytes come into shared memory with cp.async
//             while the warpgroup multiplies the span before (two buffers);
//             rows are padded to an odd number of 16-byte units so that the
//             eight rows a fragment load touches fall on different banks.
//             The weight tile is staged once per block; f32 weights are split
//             there into three bf16 that sum to each weight exactly.
//
// A warp multiplies one m-tile by the tile's n-tiles (4 beams each): 64 (or
// 32) accumulators a thread.  The four warps of a warpgroup take four output
// rows and issue each step together.  A warpgroup is the unit of work: it
// walks its own spans with its own wire buffers and its own barrier, and
// shares only the weight tile with the block's other warpgroups, so that
// one's detection runs under another's products.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wire_gemm.cuh"

namespace dsabf {

constexpr int kGroupThreads = 128;              // a warpgroup
constexpr int kMaxGroups = 4;                   // warpgroups of a block
constexpr int kTileBeams = 64;                  // beams of a weight tile
constexpr int kNarrowTileBeams = 32;            // of a float tile too large
                                                // for two warpgroups' rows
constexpr int kRoundRows = 4;                   // output rows a warpgroup
                                                // takes at a time, one a warp
constexpr int kStepBytes = 32;                  // K bytes of one mma
constexpr int kCoreBytes = 128;                 // 8 columns x 16 K bytes
constexpr int kMaxSpanRows = 16;                // output rows of a span
// Dynamic shared memory of a block: an SM's, less the caller's static SK
// scratch (1 KB a warpgroup).
constexpr int kMmaDynSmem = kMaxDynSmem - kMaxGroups * 1024;

// i / d for small operands (i * d < 2^32) without the integer divide.
struct FastDiv {
  uint32_t d, magic;
};
inline FastDiv make_fastdiv(int d) {
  FastDiv f;
  f.d = uint32_t(d);
  f.magic = d > 1 ? uint32_t((1ULL << 32) / uint32_t(d)) + 1u : 0u;
  return f;
}
__device__ __forceinline__ int fast_div(int i, const FastDiv& f) {
  return f.d == 1u ? i : int(__umulhi(uint32_t(i), f.magic));
}

// What tile_product's sums are a multiple of: the folded modes give M, the
// others 16 M (see Sub-terms above).
__host__ __device__ constexpr int product_scale(bool fold) {
  return fold ? 1 : 16;
}

// The shapes one launch works with (by value to the kernel).
struct MmaGeom {
  int a_compute;
  int bf16;         // != 0: bf16 operands, k16 steps of 8 antennas; else
                    // int8, k32 steps of 16 antennas
  int n_steps;      // k-steps of one sub-term: a_compute / 8 (bf16) or
                    // ceil(a_compute / 16) (int8)
  int n_sub;        // sub-terms along K
  int fold;         // != 0: even sub-terms multiply 16 X (int12, int13)
  int factor;       // int8, fold == 0: sums so far times this before
                    // sub-term 1
  int k_total;      // K bytes of a weight column: n_sub * 32 * n_steps
  int tile_beams;   // beams of a block's weight tile: kTileBeams or
                    // kNarrowTileBeams
  int raw_stride;   // bytes of a staged (sample, pol) wire row
  int navg;         // samples of an output row
  int mpr;          // m-tiles of an output row: ceil(navg / 8)
  int n_groups;     // warpgroups of a block, each walking its own spans
  int rows_out;     // output rows of a span
  int span_samples; // rows_out * navg: pol y's rows follow pol x's
  int copy_bytes;   // bytes of one cp.async of the wire: 16 where the
                    // wire's strides and a_compute allow it, else 4
  FastDiv copies;   // cp.async of a (sample, pol): a_compute / copy_bytes
  FastDiv words;    // wire words of a (sample, pol): a_compute / 4
  FastDiv slots;    // K slots of a re or im part the weight staging walks:
                    // int8 wire words, 4 * n_steps; bf16 antenna pairs,
                    // a_compute / 2
};

// Bytes of one buffer of a span's wire rows.
__host__ __device__ inline size_t span_wire_bytes(const MmaGeom& g) {
  return size_t(2) * g.span_samples * g.raw_stride;
}

// Bytes of a block's weight tile.
__host__ __device__ inline size_t weight_tile_bytes(const MmaGeom& g) {
  return size_t(2) * g.tile_beams * g.k_total;
}

// The warpgroups of a block and the output rows of each one's span beside a
// weight tile of wbytes, an output row's wire bytes (both buffers) being
// row_bytes; false when not one row fits.  A block is as many warpgroups
// (at most max_groups, and no more than there are rounds) as can each hold
// a span of kRoundRows rows, else one warpgroup with what fits; a span is at
// most kMaxSpanRows rows, a multiple of kRoundRows once past it.  Each
// warpgroup also keeps group_bytes of its own beside its rows.
inline bool fit_spans(int& groups, int& rows, size_t wbytes,
                      size_t row_bytes, size_t group_bytes, int n_out,
                      int max_groups) {
  if (wbytes + group_bytes + row_bytes > size_t(kMmaDynSmem)) return false;
  const long long left = kMmaDynSmem - (long long)wbytes;
  const long long gb = (long long)group_bytes;
  const int want = n_out < kRoundRows ? n_out : kRoundRows;
  const int n_rounds = (n_out + kRoundRows - 1) / kRoundRows;
  long long r = 0;
  for (groups = max_groups < n_rounds ? max_groups : n_rounds; groups >= 1;
       --groups) {
    r = (left - groups * gb) / (groups * (long long)row_bytes);
    if (r >= want) break;
  }
  if (groups < 1) {  // a single warpgroup with what fits
    groups = 1;
    r = (left - gb) / (long long)row_bytes;
  }
  if (r > kMaxSpanRows) r = kMaxSpanRows;
  if (r > n_out) r = n_out;
  if (r > kRoundRows) r -= r % kRoundRows;
  rows = int(r);
  return true;
}

// Floats a warp's restaged output row takes in shared memory: the tile's Re
// (or Im) columns and kStagePad more, so that the eight rows one store of a
// fragment touches start 4 banks apart.
constexpr int kStagePad = 4;
__host__ __device__ constexpr int stage_stride(int tile_beams) {
  return tile_beams + kStagePad;
}

// Bytes a warpgroup restages its output through, stage_rows rows a warp.
__host__ __device__ inline size_t stage_bytes(int stage_rows,
                                              int tile_beams) {
  return size_t(kGroupThreads / 32) * stage_rows * stage_stride(tile_beams)
         * sizeof(float);
}

// Fill g for these sizes and give the dynamic shared memory of a block;
// false when one output row does not fit beside the weight tile.
// bf16: the operand type (n_sub bf16 sub-terms) or int8 (n_sub int8
// sub-terms, fold and factor as IntWeights has them).  wire_align: what the
// wire's address, strides and n_ant are all multiples of (at least 4).
// max_groups: the most warpgroups the kernel's registers allow.
// stage_rows: rows of float32 output each warp restages in shared memory
// (stage_bytes, after the warpgroup's wire buffers; 0: none).  The weight
// tile is kTileBeams wide; a bf16 tile that leaves room for fewer than
// min_groups warpgroups (or the rounds, if fewer) is kNarrowTileBeams wide:
// the detect kernel asks for two (f32's three parts at a_compute 112 and
// 128 leave one, whose detection then leaves the tensor cores idle), the
// voltage kernel for three.
inline bool make_mma_geom(MmaGeom& g, size_t& smem, int a_compute, int bf16,
                          int n_sub, int fold, int factor, int navg,
                          int n_out, int wire_align, int max_groups,
                          int min_groups, int stage_rows) {
  g.a_compute = a_compute;
  g.bf16 = bf16;
  g.n_steps = bf16 ? a_compute / 8 : (a_compute + 15) / 16;
  g.n_sub = n_sub;
  g.fold = fold;
  g.factor = factor;
  g.k_total = n_sub * kStepBytes * g.n_steps;
  // The least odd number of 16-byte units that holds a_compute bytes.
  g.raw_stride = 16 * (((a_compute + 15) / 16) | 1);
  g.navg = navg;
  g.mpr = (navg + 7) / 8;
  g.copy_bytes = wire_align % 16 == 0 && a_compute % 16 == 0 ? 16 : 4;
  g.copies = make_fastdiv(a_compute / g.copy_bytes);
  g.words = make_fastdiv(a_compute / 4);
  g.slots = make_fastdiv(bf16 ? a_compute / 2 : 4 * g.n_steps);
  // An output row's wire bytes, in both buffers.
  const size_t row_bytes = size_t(2) * navg * 2 * g.raw_stride;
  const int n_rounds = (n_out + kRoundRows - 1) / kRoundRows;
  int enough = min_groups < max_groups ? min_groups : max_groups;
  if (enough > n_rounds) enough = n_rounds;
  int groups = 0, rows = 0;
  g.tile_beams = kTileBeams;
  const bool wide = fit_spans(groups, rows, weight_tile_bytes(g), row_bytes,
                              stage_bytes(stage_rows, g.tile_beams), n_out,
                              max_groups);
  if (bf16 && (!wide || groups < enough)) {
    g.tile_beams = kNarrowTileBeams;
    if (!fit_spans(groups, rows, weight_tile_bytes(g), row_bytes,
                   stage_bytes(stage_rows, g.tile_beams), n_out,
                   max_groups)) {
      return false;
    }
  } else if (!wide) {
    return false;
  }
  g.n_groups = groups;
  g.rows_out = rows;
  g.span_samples = rows * navg;
  smem = weight_tile_bytes(g)
         + size_t(groups) * (rows * row_bytes
                             + stage_bytes(stage_rows, g.tile_beams));
  return true;
}

// A barrier of one warpgroup (barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(group + 1), "r"(kGroupThreads)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

// Byte offset of column c, K byte k of the weight tile (see Columns above).
__device__ __forceinline__ int w_offset(int c, int k, const MmaGeom& g) {
  return (c >> 3) * (g.k_total * 8) + (k >> 4) * kCoreBytes + (c & 7) * 16
         + (k & 15);
}

// The weight tile of beams b0 .. b0 + TB - 1 (TB = g.tile_beams) of channel
// f into ws: column 2 * beam + (0 Re, 1 Im), along K sub-term by sub-term in
// k32 steps of [16 re rows | 16 im rows]; zeros past a_compute and past
// n_beams.  Consecutive threads take consecutive beams, so each byte load of
// a warp is one 32-byte segment.
template <int TB>
__device__ __forceinline__ void stage_weight_tile(uint8_t* ws,
                                                  const IntWeights& w,
                                                  const MmaGeom& g, int f,
                                                  int b0, int n_beams) {
  const long long b2 = 2LL * n_beams;
  const int slots = 4 * g.n_steps;
  const int aw = g.a_compute / 4;
  const int total = g.n_sub * 2 * slots * 2 * TB;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int bl = i % TB;
    const int ri = (i / TB) & 1;           // Re or Im column
    const int rest = i / (2 * TB);         // (sub-term * 2 + part) * slots + q
    const int tp = fast_div(rest, g.slots);
    const int q = rest - tp * slots;       // four antennas 4q .. 4q + 3
    const int part = tp & 1;               // re or im rows of K
    const int t = tp >> 1;
    const int b = b0 + bl;
    uint32_t v = 0;
    if (q < aw && b < n_beams) {
      const int8_t* src = sub_term(w, t) + (long long)f * w.chan_stride
                          + (long long)(part * g.a_compute + 4 * q) * b2
                          + ri * n_beams + b;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v |= uint32_t(uint8_t(src[k * b2])) << (8 * k);
      }
    }
    const int k = (t * g.n_steps + (q >> 2)) * kStepBytes + part * 16
                  + (q & 3) * 4;
    *reinterpret_cast<uint32_t*>(ws + w_offset(2 * bl + ri, k, g)) = v;
  }
}

// The float weight modes' terms (by value to the kernels): term t of
// channel f starts at term[t] + f * chan_stride elements and is [2 *
// a_compute, 2 * n_beams], bfloat16 bits (bf16: one term; bf16x2: hi, lo)
// or float32 (f32: one term, whose weights the tile splits into three bf16
// sub-terms); the channel's scale is scales[f * n_scales + n_scales - 1].
struct FloatWeights {
  const void* term[2];
  long long chan_stride;
  int n_terms;      // tensors
  int f32;          // != 0: one float32 tensor
  int n_scales;
};

// Fill a FloatWeights from the C interface's arguments: elem_size 2 takes
// n_terms (1 or 2) bfloat16 tensors w0, w1; elem_size 4 one float32 tensor
// w0.  The bf16 sub-terms it gives: n_terms, or 3 for float32.
inline bool make_float_weights(FloatWeights& w, int& n_sub, const void* w0,
                               const void* w1, int n_terms, int elem_size,
                               int a_compute, int n_beams) {
  if (!((elem_size == 4 && n_terms == 1) ||
        (elem_size == 2 && (n_terms == 1 || n_terms == 2)))) {
    return false;
  }
  w.term[0] = w0;
  w.term[1] = n_terms == 2 ? w1 : w0;
  w.chan_stride = 2LL * a_compute * 2 * n_beams;
  w.n_terms = n_terms;
  w.f32 = elem_size == 4;
  w.n_scales = n_terms;
  n_sub = w.f32 ? 3 : n_terms;
  return true;
}

// bf16 bits of x, rounded to nearest even.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return h;
}

__device__ __forceinline__ float bf16_value(uint32_t h) {
  return __uint_as_float(h << 16);
}

// Three bf16 that sum to w exactly: w1 = bf16(w), w2 = bf16(w - w1), w3 =
// w - w1 - w2.  Each difference is exact in float32 (w1 keeps w's leading 8
// bits, w2 the next 8), and w3, at most 8 significant bits in units of w's
// last bit, is a bf16 wherever that unit is (|w| >= 2^-110; a beamforming
// weight is O(1)).  A 4-bit voltage times each part is exact in float32.
__device__ __forceinline__ void split_f32(float w, uint32_t (&h)[3]) {
  h[0] = bf16_bits(w);
  const float r1 = __fsub_rn(w, bf16_value(h[0]));
  h[1] = bf16_bits(r1);
  h[2] = bf16_bits(__fsub_rn(r1, bf16_value(h[1])));
}

// The bf16 weight tile of beams b0 .. b0 + TB - 1 (TB = g.tile_beams) of
// channel f into ws: column 2 * beam + (0 Re, 1 Im), along K sub-term by
// sub-term in k16 steps of [8 re rows | 8 im rows], two bf16 (two antennas)
// a 32-bit word; zeros past n_beams.  f32's sub-terms are the three parts of
// split_f32.  Consecutive threads take consecutive beams, so the loads of a
// warp are one or two 32-byte segments.
template <int TB>
__device__ __forceinline__ void stage_weight_tile(uint8_t* ws,
                                                  const FloatWeights& w,
                                                  const MmaGeom& g, int f,
                                                  int b0, int n_beams) {
  const long long b2 = 2LL * n_beams;
  const int pairs = g.a_compute / 2;     // antenna pairs of a re or im part
  const int n_src = w.f32 ? 1 : w.n_terms;
  const int total = n_src * 2 * pairs * 2 * TB;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int bl = i % TB;
    const int ri = (i / TB) & 1;           // Re or Im column
    const int rest = i / (2 * TB);         // (term * 2 + part) * pairs + p
    const int tp = fast_div(rest, g.slots);
    const int a = 2 * (rest - tp * pairs); // antennas a, a + 1
    const int part = tp & 1;               // re or im rows of K
    const int t = tp >> 1;
    const int b = b0 + bl;
    const long long at = (long long)f * w.chan_stride
                         + (long long)(part * g.a_compute + a) * b2
                         + ri * n_beams + b;
    // K byte of antenna a in sub-term 0's step a / 8.
    const int k = ((a >> 3) * 16 + part * 8 + (a & 7)) * 2;
    const int col = 2 * bl + ri;
    const int sub_bytes = g.n_steps * kStepBytes;
    if (w.f32) {
      uint32_t h0[3] = {0u, 0u, 0u}, h1[3] = {0u, 0u, 0u};
      if (b < n_beams) {
        const float* src = static_cast<const float*>(w.term[0]) + at;
        split_f32(src[0], h0);
        split_f32(src[b2], h1);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        *reinterpret_cast<uint32_t*>(
            ws + w_offset(col, k + p * sub_bytes, g)) = h0[p] | (h1[p] << 16);
      }
    } else {
      uint32_t v = 0;
      if (b < n_beams) {
        const uint16_t* src =
            static_cast<const uint16_t*>(t ? w.term[1] : w.term[0]) + at;
        v = uint32_t(src[0]) | (uint32_t(src[b2]) << 16);
      }
      *reinterpret_cast<uint32_t*>(
          ws + w_offset(col, k + t * sub_bytes, g)) = v;
    }
  }
}

// Start the copy of n_samples samples' wire bytes (both pols, antennas 0 ..
// a_compute - 1) from `base` into raw
// [pol][sample][raw_stride], copy_bytes per cp.async, and commit it as one
// group: it runs while the warpgroup multiplies the span before (the
// calling warpgroup's threads share the work).  The stride
// arguments read both the time-major tfpa form and the channel-major ftpa
// form (wire_gemm.cuh).
__device__ __forceinline__ void fetch_span_wire(uint8_t* raw,
                                                const uint8_t* base,
                                                int n_samples,
                                                const MmaGeom& g,
                                                long long time_stride,
                                                int n_ant) {
  const int per = int(g.copies.d);
  const int total = n_samples * 2 * per;
  for (int i = threadIdx.x % kGroupThreads; i < total; i += kGroupThreads) {
    const int rp = fast_div(i, g.copies);  // sample * 2 + pol
    const int q = i - rp * per;
    const uint8_t* src = base + (long long)(rp >> 1) * time_stride
                         + (rp & 1) * n_ant + q * g.copy_bytes;
    const uint32_t dst = smem_address(
        raw + ((rp & 1) * g.span_samples + (rp >> 1)) * g.raw_stride
        + q * g.copy_bytes);
    if (g.copy_bytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst), "l"(src));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(dst), "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies; a barrier then makes every thread's
// visible.
__device__ __forceinline__ void wait_span_wire() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One k32 step of this thread's A fragment from the wire words vx (row g:
// pol x of its sample) and vy (row g + 8: pol y): a0, a1 the re bytes (K
// bytes 4q ..), a2, a3 the im bytes (16 + 4q ..); times 16 where x16.
__device__ __forceinline__ void make_fragment(uint32_t (&a)[4], uint32_t vx,
                                              uint32_t vy, bool x16) {
  if (x16) {
    a[0] = vx & 0xF0F0F0F0u;
    a[1] = vy & 0xF0F0F0F0u;
    a[2] = (vx << 4) & 0xF0F0F0F0u;
    a[3] = (vy << 4) & 0xF0F0F0F0u;
  } else {
    a[0] = sign_extend_nibbles((vx >> 4) & 0x0F0F0F0Fu);
    a[1] = sign_extend_nibbles((vy >> 4) & 0x0F0F0F0Fu);
    a[2] = sign_extend_nibbles(vx & 0x0F0F0F0Fu);
    a[3] = sign_extend_nibbles(vy & 0x0F0F0F0Fu);
  }
}

// The 4-bit two's-complement nibbles in bits 0-3 and 8-11 of v as two bf16,
// the first in the low half.  0x4300 | (u ^ 8) is bf16(136 + n) for the
// nibble u of value n (128 + 0 .. 15: one unit a step of the mantissa), so
// one fma.rn.bf16x2 that takes 136 away leaves n exactly; no table.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t v) {
  const uint32_t biased = __byte_perm((v & 0x0F0Fu) ^ 0x0808u, 0x43u, 0x4140);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;  // 0x3F80 = bf16(1), 0xC308 = bf16(-136)
}

// One k16 step of this thread's bf16 A fragment from the wire halves hx
// (row g: pol x of its sample) and hy (row g + 8: pol y), antennas 2q and
// 2q + 1 of the step: a0, a1 their re nibbles (K elements 2q, 2q + 1), a2,
// a3 their im nibbles (8 + 2q, 9 + 2q).
__device__ __forceinline__ void make_fragment_bf16(uint32_t (&a)[4],
                                                   uint32_t hx, uint32_t hy) {
  a[0] = nibbles_bf16(hx >> 4);
  a[1] = nibbles_bf16(hy >> 4);
  a[2] = nibbles_bf16(hx);
  a[3] = nibbles_bf16(hy);
}

// d (+)= a * b for one warpgroup: a is this warp's 16 x 32 fragment (rows
// 16 w .. 16 w + 15 of the 64, w the warp's rank in the warpgroup), b the
// shared-memory tile the descriptor names (128 columns x 32 K bytes),
// d[n-tile][c0..c3] this thread's part of the warp's 16 x 128 sums.
// scale_d == 0 starts the sum (d = a * b).  Asynchronous: wgmma_fence
// before, wgmma_commit and wgmma_wait after.
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same for bf16 operands (a this warp's 16 x 16 fragment, b 8 * NT
// columns x 16 K elements) into float32 sums d[n-tile][c0..c3] of the
// warp's 16 x 8 NT: m64n128k16 (NT 16) or m64n64k16 (NT 8), B K-major.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  static_assert(NT == 16 || NT == 8, "m64n128k16 or m64n64k16");
  if constexpr (NT == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
  }
}

// wgmma reads its register operands, and writes its sums, after the
// instruction has issued.  An empty asm that "rewrites" a register keeps the
// compiler from reusing it, or from reading it early, across that point.
__device__ __forceinline__ void keep_register(uint32_t& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void keep_register(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
}
__device__ __forceinline__ void keep_register(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// Orders this warp's register writes (accumulators, A fragments) before the
// warpgroup's next wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N of the committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The matrix descriptor of the weight tile at K byte 0: start address,
// leading byte offset (between the two core matrices of a step along K),
// stride byte offset (between 8-column groups), each in 16-byte units; no
// swizzle.  K byte k (a multiple of 32) starts at desc + k * 8 / 16.
__device__ __forceinline__ uint64_t w_descriptor(const uint8_t* ws,
                                                 const MmaGeom& g) {
  return uint64_t((smem_address(ws) & 0x3FFFFu) >> 4)
         | (uint64_t(kCoreBytes >> 4) << 16)
         | (uint64_t((g.k_total * 8) >> 4) << 32);
}

// Every accumulator register pinned (see keep_register).
template <typename T, int NT>
__device__ __forceinline__ void keep_sums(T (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) keep_register(acc[nt][c]);
  }
}

// The k-steps 0 .. n_k - 1 of a tile product, step(ks, a) issuing step ks
// with fragment a: two fragments in turn, so that one is made while the
// other is read; then the wait for the last, with the fragments and the
// sums pinned until it.
template <typename T, int NT, typename Step>
__device__ __forceinline__ void run_steps(T (&acc)[NT][4], int n_k,
                                          Step&& step) {
  uint32_t a0[4] = {}, a1[4] = {};
  for (int ks = 0; ks < n_k; ks += 2) {
    step(ks, a0);
    if (ks + 1 < n_k) step(ks + 1, a1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    keep_register(a0[r]);
    keep_register(a1[r]);
  }
  keep_sums(acc);
}

// One m-tile times the weight tile, every sub-term.  rx: this lane's pol x
// wire row (sample lane / 4 of the m-tile) in the staged span, pol y's
// `plane` bytes further; live: the row holds a sample (else zeros).
// acc[n-tile][c0..c3]: thread `lane` holds rows lane / 4 (c0, c1: pol x) and
// lane / 4 + 8 (c2, c3: pol y), columns Re, Im of beam 4 * n-tile + lane % 4:
// the int8 operands' integer sums times product_scale(g.fold) (the int8
// tile is kTileBeams wide), or the bf16 operands' float32 sums.
// The four warps of a warpgroup call this together.
__device__ __forceinline__ void tile_product(int (&acc)[16][4],
                                             const uint8_t* rx, int plane,
                                             bool live, const uint8_t* ws,
                                             const MmaGeom& g, int lane) {
  const int q = lane & 3;
  const int aw = g.a_compute / 4;
  const int n_k = g.n_sub * g.n_steps;
  int t = 0, s = 0;  // sub-term and step of k-step ks
  const uint64_t desc0 = w_descriptor(ws, g);
  auto step = [&](int ks, uint32_t (&a)[4]) {
    // The wire words first: their loads run under the waits below.
    const int wi = 4 * s + q;
    const bool ok = live && wi < aw;
    const uint32_t vx =
        ok ? *reinterpret_cast<const uint32_t*>(rx + 4 * wi) : 0u;
    const uint32_t vy =
        ok ? *reinterpret_cast<const uint32_t*>(rx + plane + 4 * wi) : 0u;
    // a was last read by the step before the last: at most one may run on.
    if (ks >= 2) wgmma_wait<1>();
#pragma unroll
    for (int r = 0; r < 4; ++r) keep_register(a[r]);
    if (ks == g.n_steps && !g.fold) {
      // int8x2: the hi term's sums times 256 (a multiply: a left shift of a
      // negative int is undefined), the lo term's products on top.
      wgmma_wait<0>();
      keep_sums(acc);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nt][c] *= g.factor;
      }
    }
    make_fragment(a, vx, vy, !g.fold || !(t & 1));
    wgmma_fence();
    wgmma_s8(acc, a, desc0 + uint64_t((ks * 2 * kCoreBytes) >> 4), ks > 0);
    wgmma_commit();
    if (++s == g.n_steps) {
      s = 0;
      ++t;
    }
  };
  run_steps(acc, n_k, step);
}

// The bf16 sub-terms share their A operand (the same X, only the weights
// differ), so each k16 step makes one fragment and issues every sub-term's
// product with it, in one commit group: bf16x2 and f32 make their fragments,
// and wait, once per two and three products.
template <int NT>
__device__ __forceinline__ void tile_product(float (&acc)[NT][4],
                                             const uint8_t* rx, int plane,
                                             bool live, const uint8_t* ws,
                                             const MmaGeom& g, int lane) {
  const int off = 2 * (lane & 3);  // antennas off, off + 1 of each step
  const uint64_t desc0 = w_descriptor(ws, g);
  const uint64_t sub_desc = uint64_t((g.n_steps * 2 * kCoreBytes) >> 4);
  auto step = [&](int s, uint32_t (&a)[4]) {
    // The wire halves first: their loads run under the wait below.
    const int at = 8 * s + off;
    const uint32_t hx =
        live ? *reinterpret_cast<const uint16_t*>(rx + at) : 0u;
    const uint32_t hy =
        live ? *reinterpret_cast<const uint16_t*>(rx + plane + at) : 0u;
    // a was last read by the step before the last: at most one may run on.
    if (s >= 2) wgmma_wait<1>();
#pragma unroll
    for (int r = 0; r < 4; ++r) keep_register(a[r]);
    make_fragment_bf16(a, hx, hy);
    wgmma_fence();
    // At most three sub-terms (f32's parts), written out: a loop around
    // wgmma made ptxas inject more warpgroup.arrive (C7519).
    const uint64_t desc = desc0 + uint64_t((s * 2 * kCoreBytes) >> 4);
    wgmma_bf16<NT>(acc, a, desc, s > 0);
    if (g.n_sub > 1) wgmma_bf16<NT>(acc, a, desc + sub_desc, 1);
    if (g.n_sub > 2) wgmma_bf16<NT>(acc, a, desc + 2 * sub_desc, 1);
    wgmma_commit();
  };
  run_steps(acc, g.n_steps, step);
}

}  // namespace dsabf
