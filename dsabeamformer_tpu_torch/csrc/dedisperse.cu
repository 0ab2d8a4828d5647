// dedisperse.cu -- the dedispersion bank of the single-pulse search, for
// sm_90a.
//
// Replaces the reference's XLA gather banks (dsabeamformer_tpu/ops/
// dedisperse.py: _dedisperse_jit :156, _subband_jit :179, and their
// beam-batched vmaps): a brute-force bank and the two stages of the subband
// bank.  The reference's third method, a one-hot convolution on the TPU's
// matrix unit, has no counterpart: its plan runs on the two subband kernels
// (ops/dedisperse.py, method "conv").
//
//   dsabf_dedisperse_direct  out[b, d, t] = sum_f  P[b, f, t + delay[d, f]]
//   dsabf_subband_stage1     S[b, g, j, t] = sum_c P[b, g, c, t + intra[g, j, c]]
//   dsabf_subband_stage2     out[b, d, t] = sum_g S[b, g].flat[off[g, d] + t]
//   dsabf_snr_topk           of each bank row, robust-normalized here or
//                            by the caller: its cumulative sum, then per
//                            boxcar width the top-k S/N and the peak over
//                            the row's owned starts
//   dsabf_median_rows        each row's median (the mean of the middle two
//                            of an even count): the bank's tail fill
//
// Each output sample is a float32 sum taken in ascending channel (group)
// order from zero with plain adds (__fadd_rn: nothing fused or reordered),
// so every kernel equals its plain PyTorch version and the reference's
// sequential scan bit for bit.  Which thread owns which sums is the tiling's
// choice; the order of the adds within one sum never is.
//
// What bounds it on the card: the adds (one per output sample per channel
// or group; FP32 outside the tensor cores, 128 a clock an SM), not the
// bytes (the padded columns once and the bank once are a few hundred MB a
// window).  An add that takes its sample straight from memory needs a load
// as well, and an SM issues one warp-wide load a clock (shared memory and
// L1 move 128 bytes a clock) against four warp-wide adds: a gather bank of
// one load an add (the first design of these kernels) tops out near 1/8 of
// the add rate with its shift loads, 1/4 without.  The two banks
// (dedisperse_direct, subband_stage1) share one kernel, bank_kernel, whose
// design takes most loads out of the adds:
//   - A block owns (z, kBlockTrials trials, kBlockT output samples): z the
//     beam (direct) or the beam's channel group (stage 1); each of its
//     kWarps warps kK of the trials, each lane kR consecutive samples of
//     the block's kBlockT, so every warp covers every sample of the block.
//     A thread keeps its kK x kR sums in registers.
//   - The block walks the rows (channels) in chunks of kChunk.  For each
//     chunk it stages each row's span [t0 + s_min, t0 + kBlockT + s_min +
//     kBlockSpan) in shared memory with cp.async (16 bytes a copy where the
//     rows allow it), s_min the least shift of the block's trials on that
//     row, into one of two buffers: the next chunk's copy runs under this
//     chunk's adds.  The shifts of a chunk are copied two chunks ahead and
//     summarized once per (warp, row): the least shift, where the warp's
//     windows start in the staged row, and the pattern of steps between its
//     consecutive trials.
//   - Shared across trials: on a row, a lane loads the kR + 6 floats its kK
//     trials' shifts can touch into registers once (a window), and each
//     trial adds the kR of them at its offset.  The offsets are
//     warp-uniform (every lane shares the trials and the row), so the
//     choice among the window's registers is one warp-uniform jump a row to
//     the code of the warp's pattern: the steps between its 4 trials' shifts,
//     each -1 .. 2 (64 patterns, each with its offsets as constants: no
//     divergence, no local memory).  kR is odd, so the 32 lanes' loads (kR
//     floats apart) meet 32 banks.  On the dsa10c window every (warp,
//     channel) of both banks takes a window: 21 loads, one jump and 60 adds
//     a lane and row.
//   - A row whose steps leave -1 .. 2 takes loads from the staged row per
//     trial (the offsets in bytes); one whose block span is past kBlockSpan
//     (a table that is not a DM sweep: random, steep) per-trial loads from
//     global memory: the same adds in the same order, a load each.  Paths
//     chosen by the data, in the same kernel.
//   - The sums leave through shared memory, so that a warp's stores are
//     whole runs of 32 consecutive samples of a trial.
// Stage 2 keeps its first design (a block: a beam, 16 trials, 128 samples,
// one sample a thread, the shifts staged in shared memory): bound by its
// bytes, not its adds (a few groups a sum), it ran at 61% of that bound on
// the dsa10c window.
//
// snr_topk_kernel, a block a bank row (one beam's trial series), takes the
// row in shared memory once and does the reference's whole _snr_topk_jit
// (dsabeamformer_tpu/ops/dedisperse.py:627) there.  First, unless the
// caller hands it rows already normalized, the robust normalization
// (x - med) / max(1.4826 * MAD, 1e-30) in place, each median an exact
// selection (below, "the robust normalization").  Then the reference's
// blocked cumulative sum (sequential within blocks of
// 16 from zero, the block totals scanned the same way, recursively, each
// total added to the next level's block; ops/dedisperse.py
// _cumsum_blocked), then for each width w the boxcar sums c[t + w] - c[t],
// each thread's best k of its samples (a larger sum first, the lower start
// of two equal ones: the reference's stable sort), merged over the block,
// and the largest sum over the starts below the row's limit.  The S/N is
// the sum in float64 times 1 / sqrt(w), as the reference's.  Every add is
// __fadd_rn in the reference's order, so the results equal the plain
// version bit for bit; the bank's bytes are read once.  A row longer than
// shared memory holds keeps its scan in a global scratch of its block
// instead (kTopkScratchBlocks blocks, each taking rows in turn): the same
// adds, slower.
//
// Plain C interface (no PyTorch headers), bound with ctypes; the wrapper
// checks shapes, types and devices, and the callers bound the shifts
// (0 <= shift, shift + outputs <= padded length).  Each entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ------------------------------- stage 2 ---------------------------------

constexpr int kTileT = 128;          // output samples a block owns
constexpr int kTileTrials = 16;      // trials a block owns
constexpr int kStageChannels = 256;  // shift-table columns staged at a time

// A block's kTileTrials sums of `data[row r][t + shift[k][r]]` over rows r
// in [0, n_rows), the rows `row_stride` floats apart, the shifts read as
// shift(k, r) from global memory (row-major with `shift_row` ints between
// trials, `shift_col` between rows) and staged in shared memory.
__device__ void sum_rows(const float* __restrict__ data, long long row_stride,
                         int n_rows, const int* __restrict__ shift,
                         long long shift_row, long long shift_col, int n_k,
                         int t, bool live, float (&acc)[kTileTrials]) {
  __shared__ int sh[kTileTrials][kStageChannels];
#pragma unroll
  for (int k = 0; k < kTileTrials; ++k) acc[k] = 0.0f;
  for (int r0 = 0; r0 < n_rows; r0 += kStageChannels) {
    const int nr = min(kStageChannels, n_rows - r0);
    __syncthreads();  // the previous stage's shifts have been read
    for (int i = threadIdx.x; i < kTileTrials * kStageChannels;
         i += blockDim.x) {
      const int k = i / kStageChannels, r = i % kStageChannels;
      sh[k][r] = (k < n_k && r < nr)
                     ? shift[k * shift_row + (r0 + r) * shift_col]
                     : 0;
    }
    __syncthreads();
    if (!live) continue;
    const float* col = data + r0 * row_stride + t;
    for (int r = 0; r < nr; ++r, col += row_stride) {
      // Trials past n_k read shift 0 (in range) into sums never stored.
#pragma unroll
      for (int k = 0; k < kTileTrials; ++k)
        acc[k] = __fadd_rn(acc[k], __ldg(col + sh[k][r]));
    }
  }
}

// grid (ceil(t_out / kTileT), ceil(n_dm / kTileTrials), B)
__global__ void __launch_bounds__(kTileT)
    stage2_kernel(const float* __restrict__ s, const int* __restrict__ offsets,
                  float* __restrict__ out, int n_grp, long long plane,
                  int n_dm, int t_out) {
  const int t = blockIdx.x * kTileT + threadIdx.x;
  const int d0 = blockIdx.y * kTileTrials;
  const int n_k = min(kTileTrials, n_dm - d0);
  const long long b = blockIdx.z;
  float acc[kTileTrials];
  // offsets is [G, n_dm]: trial k of this block at column d0 + k, group g
  // at row g.
  sum_rows(s + b * n_grp * plane, plane, n_grp, offsets + d0, 1, n_dm, n_k,
           t, t < t_out, acc);
  if (t >= t_out) return;
  float* o = out + (b * n_dm + d0) * t_out + t;
#pragma unroll
  for (int k = 0; k < kTileTrials; ++k)
    if (k < n_k) o[static_cast<long long>(k) * t_out] = acc[k];
}

// ------------------------- the banks: bank_kernel -------------------------

constexpr int kR = 15;                      // samples a lane owns (odd)
constexpr int kK = 4;                       // trials a warp owns
constexpr int kWarps = 8;                   // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockT = 32 * kR;            // samples a block owns: 480
constexpr int kBlockTrials = kWarps * kK;   // trials a block owns: 32
constexpr int kMinStep = -1;                // the steps between a warp's
constexpr int kMaxStep = 2;                 // consecutive trials its window
                                            // takes
constexpr int kSteps = kMaxStep - kMinStep + 1;
constexpr int kPatterns = kSteps * kSteps * kSteps;  // 64: steps of 3 pairs
constexpr int kWin = kR + (kK - 1) * kMaxStep;       // window registers: 21
constexpr int kBlockSpan = 60;              // widest block span staged
// Floats of a staged row: the block's samples, its span, up to 3 of lead
// and room for a window's last registers past what a pattern reads.
constexpr int kRow = kBlockT + kBlockSpan + 4 + 8;
constexpr int kChunk = 16;                  // rows a stage holds
constexpr int kMetaBufs = 3;                // shift summaries in flight
// Dynamic shared memory: two stages of kChunk rows.
constexpr int kBankSmem = 2 * kChunk * kRow * int(sizeof(float));
// How a warp adds a row (WarpRow::path): 0 .. kPatterns - 1 the register
// window at that pattern of steps; then loads from the staged row per
// trial; then loads from global memory per trial.
constexpr int kStagedPath = kPatterns;
constexpr int kGlobalPath = kPatterns + 1;

static_assert(kR % 2 == 1, "lanes kR floats apart must meet 32 banks");
static_assert(kWarps * kK * kBlockT <= 2 * kChunk * kRow,
              "the sums leave through the staged rows' memory");
static_assert(kRow % 4 == 0, "staged rows start on 16 bytes");
static_assert(kK == 4, "a pattern is the steps of 3 pairs of trials");

// What a warp's trials need of one row: their shifts' offsets from the
// least of them (8 bits each, trial j in bits 8j ..; staged path), how the
// warp adds the row and where in the staged row its lanes' windows (the
// least shift's samples) start (summarize); 16 bytes, one load a row.
struct __align__(16) WarpRow {
  int offsets, path, at;
};
// What the block's trials need of one row: their least shift and span.
struct BlockRow {
  int s_min, span;
};

// The block-uniform description of one launch's rows, trials and outputs.
struct Bank {
  const float* data;       // row r of z at data + z * data_z + r * t_pad
  long long data_z, t_pad;
  int n_rows;
  const int* table;        // shift of trial d on row r of z:
  long long table_z;       //   table[(z % z_mod) * table_z + d * n_rows + r]
  int z_mod;
  int n_trials;
  float* out;              // out[z * out_z + d * t_out + t]
  long long out_z;
  int t_out;
  int vec;                 // != 0: rows and data start on 16 bytes
};

// The shift of trial d (clamped into the table: trials past n_trials take
// the last one's, so they add no step) on row r of the table.
__device__ __forceinline__ int shift_of(const int* tab, const Bank& k, int d,
                                        int r) {
  return __ldg(tab + (long long)min(d, k.n_trials - 1) * k.n_rows + r);
}

// The floats of a staged row before the block's first sample: aligning the
// copy's start down to 16 bytes.
__device__ __forceinline__ int lead_of(const Bank& k, long long start) {
  return k.vec ? int(start & 3) : 0;
}

// The summarizing threads: one a (warp, row of a chunk), thread c * kWarps
// + w for warp w and row c, so that a row's warps are neighbouring lanes.
constexpr int kSummarizers = kWarps * kChunk;
static_assert(kSummarizers % 32 == 0 && kSummarizers <= kThreads,
              "whole warps summarize");
static_assert(32 % kWarps == 0, "a row's warps share a warp");

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Until this thread's copies have landed (a barrier then shows every
// thread's).
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copies of the shifts of warp w's trials on row r0 + c into
// raw[tid] (each summarizing thread its own: no barrier between its copy
// and its read).
__device__ __forceinline__ void fetch_shifts(int (*raw)[kK], const int* tab,
                                             const Bank& k, int d0, int r0,
                                             int nr) {
  const int tid = threadIdx.x;
  const int c = tid / kWarps, w = tid % kWarps;
  if (tid >= kSummarizers || c >= nr) return;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    const int d = min(d0 + w * kK + j, k.n_trials - 1);
    const int* src = tab + (long long)d * k.n_rows + r0 + c;
    const uint32_t dst = uint32_t(__cvta_generic_to_shared(&raw[tid][j]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src));
  }
}

// The summaries of rows r0 .. r0 + nr - 1 from the shifts fetch_shifts
// brought (after this thread's cp.async.wait_group), by the summarizing
// threads.  Warp w's of row c: a window pattern where each trial's shift
// is its predecessor's plus kMinStep .. kMaxStep (pattern = the steps less
// kMinStep in base kSteps, the first pair's lowest), else the staged path
// where its offsets from its least shift fit 8 bits, else the global path;
// and where its lanes' windows start in the staged row.  The block's (its
// warps' least shift and span, reduced across the row's kWarps lanes): the
// global path for every warp where the span is past kBlockSpan.
__device__ __forceinline__ void summarize(const int (*raw)[kK], int nr,
                                          WarpRow (*wr)[kChunk],
                                          BlockRow* br, const Bank& k,
                                          int t0) {
  const int tid = threadIdx.x;
  if (tid >= kSummarizers) return;  // whole warps
  const int c = tid / kWarps, w = tid % kWarps;
  const int* s = raw[tid];          // garbage past nr: never written out
  int lo = s[0], hi = s[0], pattern = 0, scale = 1;
  bool steps = true;
#pragma unroll
  for (int j = 1; j < kK; ++j) {
    lo = min(lo, s[j]);
    hi = max(hi, s[j]);
    const int step = s[j] - s[j - 1];
    const bool in = step >= kMinStep && step <= kMaxStep;
    steps = steps && in;
    pattern += (in ? step - kMinStep : 0) * scale;
    scale *= kSteps;
  }
  const bool narrow = hi - lo < 256;
  int offsets = 0;
  if (narrow) {
#pragma unroll
    for (int j = 0; j < kK; ++j) offsets |= (s[j] - lo) << (8 * j);
  }
  int b_lo = lo, b_hi = hi, b_wide = !narrow;
#pragma unroll
  for (int m = 1; m < kWarps; m <<= 1) {
    b_lo = min(b_lo, __shfl_xor_sync(0xffffffffu, b_lo, m));
    b_hi = max(b_hi, __shfl_xor_sync(0xffffffffu, b_hi, m));
    b_wide |= __shfl_xor_sync(0xffffffffu, b_wide, m);
  }
  if (c >= nr) return;
  const int span = b_wide ? kBlockSpan + 1 : b_hi - b_lo;
  const bool global = span > kBlockSpan;
  wr[w][c] = WarpRow{offsets,
                     global  ? kGlobalPath
                     : steps ? pattern
                             : kStagedPath,
                     lead_of(k, (long long)t0 + b_lo) + lo - b_lo};
  if (w == 0) br[c] = BlockRow{b_lo, span};
}

// Start the copies of rows r0 .. r0 + nr - 1 of z's data, each from t0 +
// s_min - lead for kRow floats (those below t_pad), STEP floats a copy,
// into rows.  A row whose block span is past kBlockSpan is not staged (its
// warps take per-trial loads from global memory).
template <int STEP>
__device__ __forceinline__ void copy_rows(float* rows, const float* data,
                                          const Bank& k, int t0, int r0,
                                          int nr, const BlockRow* br) {
  constexpr int per = kRow / STEP;   // copies of a row
  for (int i = threadIdx.x; i < nr * per; i += kThreads) {
    const int c = i / per, q = i - c * per;
    const BlockRow b = br[c];
    if (b.span > kBlockSpan) continue;
    const long long want = (long long)t0 + b.s_min;
    const long long at = want - lead_of(k, want) + (long long)q * STEP;
    if (at + STEP > k.t_pad) continue;
    const float* src = data + (long long)(r0 + c) * k.t_pad + at;
    const uint32_t dst = uint32_t(__cvta_generic_to_shared(
        rows + c * kRow + q * STEP));
    if constexpr (STEP == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst), "l"(src));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(dst), "l"(src));
    }
  }
}

__device__ __forceinline__ void stage_rows(float* rows, const float* data,
                                           const Bank& k, int t0, int r0,
                                           int nr, const BlockRow* br) {
  if (k.vec) {
    copy_rows<4>(rows, data, k, t0, r0, nr, br);
  } else {
    copy_rows<1>(rows, data, k, t0, r0, nr, br);
  }
}

// The offset of trial J from the warp's least shift in pattern P.
template <int P, int J>
__host__ __device__ constexpr int pattern_offset() {
  int c[kK] = {0, 0, 0, 0};
  int p = P, lo = 0;
  for (int j = 1; j < kK; ++j, p /= kSteps) {
    c[j] = c[j - 1] + p % kSteps + kMinStep;
    lo = c[j] < lo ? c[j] : lo;
  }
  return c[J] - lo;
}

// The lane's window of a row on the window path: kWin floats from its
// first sample's place in the staged row.
__device__ __forceinline__ void load_window(float (&win)[kWin],
                                            const float* row,
                                            const WarpRow& m, int tl) {
  const float* src = row + m.at + tl;
#pragma unroll
  for (int i = 0; i < kWin; ++i) win[i] = src[i];
}

// acc[j][r] += win[o_j + r] with pattern P's offsets.
template <int P>
__device__ __forceinline__ void add_pattern(float (&acc)[kK][kR],
                                            const float (&win)[kWin]) {
  constexpr int off[kK] = {pattern_offset<P, 0>(), pattern_offset<P, 1>(),
                           pattern_offset<P, 2>(), pattern_offset<P, 3>()};
#pragma unroll
  for (int j = 0; j < kK; ++j) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      acc[j][r] = __fadd_rn(acc[j][r], win[off[j] + r]);
    }
  }
}

// One row's adds from the lane's window: a warp-uniform jump to the code of
// the warp's pattern.
__device__ __forceinline__ void add_window(float (&acc)[kK][kR],
                                           const float (&win)[kWin],
                                           int pattern) {
  switch (pattern) {
    case 0: add_pattern<0>(acc, win); break;
    case 1: add_pattern<1>(acc, win); break;
    case 2: add_pattern<2>(acc, win); break;
    case 3: add_pattern<3>(acc, win); break;
    case 4: add_pattern<4>(acc, win); break;
    case 5: add_pattern<5>(acc, win); break;
    case 6: add_pattern<6>(acc, win); break;
    case 7: add_pattern<7>(acc, win); break;
    case 8: add_pattern<8>(acc, win); break;
    case 9: add_pattern<9>(acc, win); break;
    case 10: add_pattern<10>(acc, win); break;
    case 11: add_pattern<11>(acc, win); break;
    case 12: add_pattern<12>(acc, win); break;
    case 13: add_pattern<13>(acc, win); break;
    case 14: add_pattern<14>(acc, win); break;
    case 15: add_pattern<15>(acc, win); break;
    case 16: add_pattern<16>(acc, win); break;
    case 17: add_pattern<17>(acc, win); break;
    case 18: add_pattern<18>(acc, win); break;
    case 19: add_pattern<19>(acc, win); break;
    case 20: add_pattern<20>(acc, win); break;
    case 21: add_pattern<21>(acc, win); break;
    case 22: add_pattern<22>(acc, win); break;
    case 23: add_pattern<23>(acc, win); break;
    case 24: add_pattern<24>(acc, win); break;
    case 25: add_pattern<25>(acc, win); break;
    case 26: add_pattern<26>(acc, win); break;
    case 27: add_pattern<27>(acc, win); break;
    case 28: add_pattern<28>(acc, win); break;
    case 29: add_pattern<29>(acc, win); break;
    case 30: add_pattern<30>(acc, win); break;
    case 31: add_pattern<31>(acc, win); break;
    case 32: add_pattern<32>(acc, win); break;
    case 33: add_pattern<33>(acc, win); break;
    case 34: add_pattern<34>(acc, win); break;
    case 35: add_pattern<35>(acc, win); break;
    case 36: add_pattern<36>(acc, win); break;
    case 37: add_pattern<37>(acc, win); break;
    case 38: add_pattern<38>(acc, win); break;
    case 39: add_pattern<39>(acc, win); break;
    case 40: add_pattern<40>(acc, win); break;
    case 41: add_pattern<41>(acc, win); break;
    case 42: add_pattern<42>(acc, win); break;
    case 43: add_pattern<43>(acc, win); break;
    case 44: add_pattern<44>(acc, win); break;
    case 45: add_pattern<45>(acc, win); break;
    case 46: add_pattern<46>(acc, win); break;
    case 47: add_pattern<47>(acc, win); break;
    case 48: add_pattern<48>(acc, win); break;
    case 49: add_pattern<49>(acc, win); break;
    case 50: add_pattern<50>(acc, win); break;
    case 51: add_pattern<51>(acc, win); break;
    case 52: add_pattern<52>(acc, win); break;
    case 53: add_pattern<53>(acc, win); break;
    case 54: add_pattern<54>(acc, win); break;
    case 55: add_pattern<55>(acc, win); break;
    case 56: add_pattern<56>(acc, win); break;
    case 57: add_pattern<57>(acc, win); break;
    case 58: add_pattern<58>(acc, win); break;
    case 59: add_pattern<59>(acc, win); break;
    case 60: add_pattern<60>(acc, win); break;
    case 61: add_pattern<61>(acc, win); break;
    case 62: add_pattern<62>(acc, win); break;
    default: add_pattern<63>(acc, win); break;
  }
}
static_assert(kPatterns == 64, "add_window lists 64 patterns");

// grid (ceil(n_trials / kBlockTrials), ceil(t_out / kBlockT), Z): the
// trial tiles of one (z, sample tile) neighbours, so that all but the first
// find its rows in the L2 cache.
__global__ void __launch_bounds__(kThreads, 2) bank_kernel(Bank k) {
  extern __shared__ __align__(16) float rows_smem[];
  __shared__ WarpRow warp_rows[kMetaBufs][kWarps][kChunk];
  __shared__ BlockRow block_rows[kMetaBufs][kChunk];
  __shared__ int raw_shifts[kSummarizers][kK];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kBlockTrials;
  const int t0 = blockIdx.y * kBlockT;
  const long long z = blockIdx.z;
  const float* data = k.data + z * k.data_z;
  const int* tab = k.table + (z % k.z_mod) * k.table_z;
  const int tl = lane * kR;                 // the lane's first sample, local
  const int dw = d0 + warp * kK;            // the warp's first trial

  float acc[kK][kR];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[j][r] = 0.0f;
  }

  // Chunk ch's rows in stage ch & 1, its summaries in buffer ch % 3; the
  // copies of chunk ch + 1's rows and chunk ch + 2's shifts run under
  // chunk ch's adds.
  const int n_chunks = (k.n_rows + kChunk - 1) / kChunk;
  auto rows_in = [&](int ch) { return min(kChunk, k.n_rows - ch * kChunk); };
  for (int ch = 0; ch < 2 && ch < n_chunks; ++ch) {
    fetch_shifts(raw_shifts, tab, k, d0, ch * kChunk, rows_in(ch));
    commit_copies();
    wait_copies();
    summarize(raw_shifts, rows_in(ch), warp_rows[ch], block_rows[ch], k, t0);
    if (ch == 0) {
      __syncthreads();
      stage_rows(rows_smem, data, k, t0, 0, rows_in(0), block_rows[0]);
      // A group of its own: cp.async.wait_group waits only for committed
      // groups, and a table of one chunk commits nothing after this.
      commit_copies();
    }
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int r0 = ch * kChunk;
    const int nr = rows_in(ch);
    // Chunk ch's rows and chunk ch + 1's summaries are complete; every
    // thread is done with chunk ch - 1 (its stage and summaries).  The one
    // barrier of a chunk.
    wait_copies();
    __syncthreads();
    if (ch + 1 < n_chunks) {
      stage_rows(rows_smem + ((ch + 1) & 1) * kChunk * kRow, data, k, t0,
                 r0 + kChunk, rows_in(ch + 1),
                 block_rows[(ch + 1) % kMetaBufs]);
    }
    if (ch + 2 < n_chunks) {
      fetch_shifts(raw_shifts, tab, k, d0, r0 + 2 * kChunk, rows_in(ch + 2));
    }
    commit_copies();
    const float* rows = rows_smem + (ch & 1) * kChunk * kRow;
    const WarpRow* wr = warp_rows[ch % kMetaBufs][warp];
    // A warp whose trials are all past the table skips the adds.
    const int nw = dw < k.n_trials ? nr : 0;
    for (int c = 0; c < nw; ++c) {
      const WarpRow m = wr[c];
      if (m.path < kStagedPath) {
        float win[kWin];
        load_window(win, rows + c * kRow, m, tl);
        add_window(acc, win, m.path);
      } else if (m.path == kStagedPath) {
        const float* src = rows + c * kRow + m.at + tl;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const float* at = src + ((m.offsets >> (8 * j)) & 255);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            acc[j][r] = __fadd_rn(acc[j][r], at[r]);
          }
        }
      } else {
        // Per-trial loads: samples past t_out (sums never stored) read the
        // last live one's.
        const float* col = data + (long long)(r0 + c) * k.t_pad;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
          const float* at = col + shift_of(tab, k, dw + j, r0 + c);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            acc[j][r] = __fadd_rn(
                acc[j][r], __ldg(at + min(t0 + tl + r, k.t_out - 1)));
          }
        }
      }
    }
    if (ch + 2 < n_chunks) {
      wait_copies();
      summarize(raw_shifts, rows_in(ch + 2), warp_rows[(ch + 2) % kMetaBufs],
                block_rows[(ch + 2) % kMetaBufs], k, t0);
    }
  }

  // The sums leave through the staged rows' memory, a warp's kK trials at
  // a time, so that each store of a warp is 32 consecutive samples of one
  // trial (a lane's own kR samples are kR floats apart from its
  // neighbours').
  __syncthreads();  // every warp is done with the staged rows
  float* sums = rows_smem + warp * kK * kBlockT;
#pragma unroll
  for (int j = 0; j < kK; ++j) {
#pragma unroll
    for (int r = 0; r < kR; ++r) sums[j * kBlockT + tl + r] = acc[j][r];
  }
  __syncwarp();
  float* out = k.out + z * k.out_z;
  const int n_t = min(kBlockT, k.t_out - t0);
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    if (dw + j >= k.n_trials) break;
    float* o = out + (long long)(dw + j) * k.t_out + t0;
    for (int i = lane; i < n_t; i += 32) o[i] = sums[j * kBlockT + i];
  }
}

cudaError_t launch_bank(const Bank& k, long long n_z, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBankSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((k.n_trials + kBlockTrials - 1) / kBlockTrials,
                  (k.t_out + kBlockT - 1) / kBlockT,
                  static_cast<unsigned>(n_z));
  bank_kernel<<<grid, kThreads, kBankSmem, stream>>>(k);
  return cudaGetLastError();
}

// Rows start on 16 bytes when the data does and every row and z stride is
// a multiple of 4 floats.
int vec_of(const float* p, long long t_pad, long long data_z) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && t_pad % 4 == 0 &&
         data_z % 4 == 0;
}

// ------------------------------- top-k -----------------------------------

constexpr int kTopkThreads = 256;    // threads of a row's block
constexpr int kTopkMaxK = 8;         // the most peaks a (width, trial) keeps
constexpr int kScanBlock = 16;       // the reference's cumulative-sum block
constexpr int kTopkScratchBlocks = 1024;  // blocks of a scan in global memory

struct Topk {
  const float* bank;   // [rows, t]: rows = b * n_dm, bank rows
  int normalize;       // 1: normalize each row here; 0: they come normalized
  long long rows;
  int n_dm;
  int t;
  const int* widths;   // [n_w]
  int n_w;
  int k;
  const int* limit;    // [n_w, n_dm]: starts a (width, trial) owns
  double* snr;         // [b, n_w, n_dm, k]
  long long* idx;      // [b, n_w, n_dm, k]
  double* peak;        // [b, n_w, n_dm]
  float* scratch;      // [grid, topk_scan_floats(t)], or null: the scan in
                       // shared memory
};

// Floats of shared memory before the merge's lists: the cumulative sum
// (t + 1) and the block totals of every level above it.
__host__ __device__ inline int topk_scan_floats(int t) {
  int n = t + 1, level = t;
  while ((level + kScanBlock - 1) / kScanBlock > 1) {
    level = (level + kScanBlock - 1) / kScanBlock;
    n += level;
  }
  return (n + 3) / 4 * 4;
}

__host__ __device__ inline int topk_smem_bytes(int t) {
  return topk_scan_floats(t) * 4 + kTopkThreads * kTopkMaxK * 8;
}

__device__ inline float neg_inf() { return __int_as_float(0xff800000); }

// (v, i) before (w, j): the larger sum, or the lower start of equal ones.
__device__ inline bool before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// ------------------------ the robust normalization ------------------------
//
// The reference's (ops/dedisperse.py _normalize, _median_last): med the
// row's median, MAD the median of |x - med|, each the mean of the two middle
// values of an even count (the upper one is the lower where more than half
// the values are at most it, else the least value above it), then
// (x - med) / max(MAD * 1.4826, 1e-30), every step one float32 operation
// rounded to nearest as torch's are.  The lower middle value is an exact
// selection: a radix select over order-preserving uint32 keys (torch's
// radix select's, so -0 orders before +0 as kthvalue orders them), four
// passes of 8-bit digits, each through a 256-bin histogram in shared
// memory and a block-wide scan of it to find the digit that holds the rank.
// The MAD's values |x - med| are made afresh on each pass, never stored.
// Values near the median share their high digits, so a warp adds each
// distinct digit of its lanes once (one add where all 32 agree) rather than
// queueing 32 atomics on one bin.  What bounds it: shared-memory reads and
// the histogram's atomics, ~9 passes over the row against the scan's few.

constexpr int kBins = 256;           // a radix digit's bins (8 bits)
static_assert(kBins == kTopkThreads, "the scan over the bins: a bin a thread");
// Shared words of a selection: the histogram, a count a warp, the digit
// picked and the rank left within it, a float a warp.
constexpr int kSelectWords = kBins + 2 * (kTopkThreads / 32) + 2;

// torch's key of a float (TopKTypeConfig<float>::convert): unsigned order is
// the float order, -0 before +0, NaN last.
__device__ inline unsigned order_key(float v) {
  const unsigned x = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  return x ^ ((x & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ inline float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

struct Same {
  __device__ float operator()(float v) const { return v; }
};

struct AbsDev {  // |x - med|, as the reference's (bank - med).abs()
  float med;
  __device__ float operator()(float v) const {
    return fabsf(__fsub_rn(v, med));
  }
};

// The key of the rank-th smallest (from 0) of value(x[j]), j in [0, n), to
// every thread of the block (kTopkThreads threads, all of which call it;
// ws: kSelectWords words of shared memory).
template <class Value>
__device__ unsigned select_key(const float* x, int n, unsigned rank,
                               Value value, unsigned* ws) {
  unsigned* hist = ws;
  unsigned* part = ws + kBins;
  unsigned* pick = part + kTopkThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();  // x is written and the bins are zero
    // Every lane of a warp goes round alike: the vote and the match need
    // all 32.
    for (int j0 = 0; j0 < n; j0 += kTopkThreads) {
      const int j = j0 + tid;
      unsigned bin = kBins;  // none
      if (j < n) {
        const unsigned key = order_key(value(x[j]));
        if ((key & mask) == prefix) bin = (key >> shift) & (kBins - 1);
      }
      const unsigned first = __shfl_sync(0xffffffffu, bin, 0);
      if (__all_sync(0xffffffffu, bin == first)) {
        if (lane == 0 && bin < kBins) atomicAdd(hist + bin, 32u);
      } else {
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin < kBins && lane == __ffs(peers) - 1)
          atomicAdd(hist + bin, static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    // The digit holding the rank: an inclusive scan over the bins, a bin a
    // thread.
    const unsigned h = hist[tid];
    unsigned incl = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += part[w];
    if (rank >= incl - h && rank < incl) {
      pick[0] = tid;
      pick[1] = rank - (incl - h);
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    mask |= static_cast<unsigned>(kBins - 1) << shift;
    rank = pick[1];
  }
  return prefix;
}

// The block's sum of `count` and least of `least`, to every thread.
__device__ void block_count_min(unsigned& count, float& least,
                                unsigned* ws) {
  unsigned* part = ws + kBins;
  float* fpart =
      reinterpret_cast<float*>(part + kTopkThreads / 32 + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
    least = fminf(least, __shfl_xor_sync(0xffffffffu, least, o));
  }
  if (lane == 0) {
    part[warp] = count;
    fpart[warp] = least;
  }
  __syncthreads();
  count = 0;
  least = __int_as_float(0x7f800000);
  for (int w = 0; w < kTopkThreads / 32; ++w) {
    count += part[w];
    least = fminf(least, fpart[w]);
  }
}

// The median of value(x[j]), j in [0, n), as _median_last takes it, to
// every thread.
template <class Value>
__device__ float row_median(const float* x, int n, Value value,
                            unsigned* ws) {
  const float lo = key_value(select_key(x, n, (n - 1) / 2, value, ws));
  float hi = lo;
  if (n % 2 == 0) {
    unsigned at_most = 0;
    float above = __int_as_float(0x7f800000);  // +inf: none above
    for (int j = threadIdx.x; j < n; j += kTopkThreads) {
      const float v = value(x[j]);
      if (v <= lo) ++at_most;
      if (v > lo) above = fminf(above, v);
    }
    block_count_min(at_most, above, ws);
    hi = at_most > static_cast<unsigned>(n / 2) ? lo : above;
  }
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// x[0 .. n) robust-normalized in place.  The clamp keeps a NaN, as
// torch.clamp does.
__device__ void normalize_row(float* x, int n, unsigned* ws) {
  const float med = row_median(x, n, Same(), ws);
  const float mad = row_median(x, n, AbsDev{med}, ws);
  const float s = __fmul_rn(mad, 1.4826f);
  const float sigma = s < 1e-30f ? 1e-30f : s;
  for (int j = threadIdx.x; j < n; j += kTopkThreads)
    x[j] = __fdiv_rn(__fsub_rn(x[j], med), sigma);
}

__global__ void __launch_bounds__(kTopkThreads)
    snr_topk_kernel(Topk q) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int t = q.t;
  // c[0] = 0, c[1 + j] = the scan: in shared memory before the merge's
  // lists, or in the block's own piece of the scratch.
  float* c = q.scratch ? q.scratch + static_cast<long long>(blockIdx.x) *
                                         topk_scan_floats(t)
                       : smem;
  float* lv[8];
  int ln[8];
  float* merge_v = q.scratch ? smem : smem + topk_scan_floats(t);
  int* merge_i = reinterpret_cast<int*>(merge_v + kTopkThreads * kTopkMaxK);
  __shared__ float warp_max[kTopkThreads / 32];

  for (long long r = blockIdx.x; r < q.rows; r += gridDim.x) {
    const float* row = q.bank + r * t;
    __syncthreads();  // the previous row's lists have been read
    for (int j = tid; j < t; j += kTopkThreads) c[1 + j] = row[j];
    if (tid == 0) c[0] = 0.0f;
    // The selections' workspace is the merge lists' memory, free until the
    // first width.
    if (q.normalize)
      normalize_row(c + 1, t, reinterpret_cast<unsigned*>(merge_v));
    // Up the levels: each block's sums in place, its total one level up.
    lv[0] = c + 1;
    ln[0] = t;
    int top = 0;
    float* next = c + 1 + t;
    while ((ln[top] + kScanBlock - 1) / kScanBlock > 1) {
      const int nb = (ln[top] + kScanBlock - 1) / kScanBlock;
      __syncthreads();
      float* a = lv[top];
      const int n = ln[top];
      for (int b = tid; b < nb; b += kTopkThreads) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < kScanBlock; ++i) {
          const int j = b * kScanBlock + i;
          acc = __fadd_rn(acc, j < n ? a[j] : 0.0f);
          if (j < n) a[j] = acc;
        }
        next[b] = acc;
      }
      lv[top + 1] = next;
      ln[top + 1] = nb;
      next += nb;
      ++top;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int j = 0; j < ln[top]; ++j) {
        acc = __fadd_rn(acc, lv[top][j]);
        lv[top][j] = acc;
      }
    }
    // Down the levels: each block's sums after the totals before it.
    for (int l = top - 1; l >= 0; --l) {
      __syncthreads();
      float* a = lv[l];
      const float* up = lv[l + 1];
      for (int j = tid; j < ln[l]; j += kTopkThreads) {
        const int b = j / kScanBlock;
        a[j] = __fadd_rn(b == 0 ? 0.0f : up[b - 1], a[j]);
      }
    }
    __syncthreads();

    const long long bi = r / q.n_dm;
    const int d = static_cast<int>(r % q.n_dm);
    for (int wi = 0; wi < q.n_w; ++wi) {
      __syncthreads();  // the last width's lists and maxima have been read
      const int w = q.widths[wi];
      const int n_s = t - w + 1;
      const int lim = q.limit[wi * q.n_dm + d];
      float v[kTopkMaxK];
      int ix[kTopkMaxK];
#pragma unroll
      for (int m = 0; m < kTopkMaxK; ++m) {
        v[m] = neg_inf();
        ix[m] = 0x7fffffff;
      }
      float last_v = neg_inf();   // the list's k-th entry
      int last_i = 0x7fffffff;
      float pmax = neg_inf();
      for (int j = tid; j < n_s; j += kTopkThreads) {
        const float s = __fsub_rn(c[j + w], c[j]);
        if (j < lim) pmax = fmaxf(pmax, s);
        if (!before(s, j, last_v, last_i)) continue;
        // Insert, keeping the list in order (its entries are earlier
        // starts, so an equal sum goes after them).
        float cv = s;
        int ci = j;
#pragma unroll
        for (int m = 0; m < kTopkMaxK; ++m) {
          if (m < q.k && before(cv, ci, v[m], ix[m])) {
            const float tv = v[m];
            const int ti = ix[m];
            v[m] = cv;
            ix[m] = ci;
            cv = tv;
            ci = ti;
          }
          if (m == q.k - 1) {
            last_v = v[m];
            last_i = ix[m];
          }
        }
      }
      // The block's largest owned sum.
      for (int o = 16; o > 0; o >>= 1)
        pmax = fmaxf(pmax, __shfl_down_sync(0xffffffffu, pmax, o));
      if ((tid & 31) == 0) warp_max[tid >> 5] = pmax;
      // The block's best k: the threads' lists merged pairwise.
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kTopkMaxK; ++m) {
        merge_v[tid * kTopkMaxK + m] = v[m];
        merge_i[tid * kTopkMaxK + m] = ix[m];
      }
      for (int half = kTopkThreads / 2; half > 0; half >>= 1) {
        __syncthreads();
        if (tid < half) {
          const float* av = merge_v + tid * kTopkMaxK;
          const int* ai = merge_i + tid * kTopkMaxK;
          const float* bv = merge_v + (tid + half) * kTopkMaxK;
          const int* bi2 = merge_i + (tid + half) * kTopkMaxK;
          float ov[kTopkMaxK];
          int oi[kTopkMaxK];
          int pa = 0, pb = 0;
          for (int m = 0; m < q.k; ++m) {
            if (before(av[pa], ai[pa], bv[pb], bi2[pb])) {
              ov[m] = av[pa];
              oi[m] = ai[pa];
              ++pa;
            } else {
              ov[m] = bv[pb];
              oi[m] = bi2[pb];
              ++pb;
            }
          }
          for (int m = 0; m < q.k; ++m) {
            merge_v[tid * kTopkMaxK + m] = ov[m];
            merge_i[tid * kTopkMaxK + m] = oi[m];
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        const double inv = __ddiv_rn(1.0, __dsqrt_rn(static_cast<double>(w)));
        const long long o = (bi * q.n_w + wi) * q.n_dm + d;
        for (int m = 0; m < q.k; ++m) {
          q.snr[o * q.k + m] =
              __dmul_rn(static_cast<double>(merge_v[m]), inv);
          q.idx[o * q.k + m] = merge_i[m];
        }
        float best = warp_max[0];
        for (int i = 1; i < kTopkThreads / 32; ++i)
          best = fmaxf(best, warp_max[i]);
        q.peak[o] = __dmul_rn(static_cast<double>(best), inv);
      }
    }
  }
}

// grid: a block a row (rows taken in turn past the grid).
__global__ void __launch_bounds__(kTopkThreads)
    median_rows_kernel(const float* x, float* out, long long rows, int n) {
  __shared__ unsigned ws[kSelectWords];
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const float m = row_median(x + r * n, n, Same(), ws);
    if (threadIdx.x == 0) out[r] = m;
  }
}

}  // namespace

extern "C" {

int dsabf_dedisperse_direct(const float* p, const int* delays, float* out,
                            int b, int n_chan, long long t_pad, int n_dm,
                            int t_out, cudaStream_t stream) {
  if (b <= 0 || n_dm <= 0 || t_out <= 0) return 0;
  if (b > 65535 || n_chan <= 0) return int(cudaErrorInvalidValue);
  Bank k;
  k.data = p;
  k.data_z = static_cast<long long>(n_chan) * t_pad;
  k.t_pad = t_pad;
  k.n_rows = n_chan;
  k.table = delays;
  k.table_z = 0;
  k.z_mod = 1;
  k.n_trials = n_dm;
  k.out = out;
  k.out_z = static_cast<long long>(n_dm) * t_out;
  k.t_out = t_out;
  k.vec = vec_of(p, t_pad, k.data_z);
  return static_cast<int>(launch_bank(k, b, stream));
}

int dsabf_subband_stage1(const float* p, const int* intra, float* s, int b,
                         int n_grp, int n_cpg, long long t_pad, int n_coarse,
                         int t1, cudaStream_t stream) {
  if (b <= 0 || n_grp <= 0 || n_coarse <= 0 || t1 <= 0) return 0;
  const long long n_z = static_cast<long long>(b) * n_grp;
  if (n_z > 65535 || n_cpg <= 0) return int(cudaErrorInvalidValue);
  Bank k;
  k.data = p;
  k.data_z = static_cast<long long>(n_cpg) * t_pad;
  k.t_pad = t_pad;
  k.n_rows = n_cpg;
  k.table = intra;
  k.table_z = static_cast<long long>(n_coarse) * n_cpg;
  k.z_mod = n_grp;
  k.n_trials = n_coarse;
  k.out = s;
  k.out_z = static_cast<long long>(n_coarse) * t1;
  k.t_out = t1;
  k.vec = vec_of(p, t_pad, k.data_z);
  return static_cast<int>(launch_bank(k, n_z, stream));
}

int dsabf_subband_stage2(const float* s, const int* offsets, float* out,
                         int b, int n_grp, long long plane, int n_dm,
                         int t_out, cudaStream_t stream) {
  if (b <= 0 || n_dm <= 0 || t_out <= 0) return 0;
  const dim3 grid((t_out + kTileT - 1) / kTileT,
                  (n_dm + kTileTrials - 1) / kTileTrials,
                  static_cast<unsigned>(b));
  stage2_kernel<<<grid, kTileT, 0, stream>>>(s, offsets, out, n_grp, plane,
                                             n_dm, t_out);
  return static_cast<int>(cudaGetLastError());
}

int dsabf_snr_topk(const float* bank, const int* widths, const int* limit,
                   double* snr, long long* idx, double* peak, int b, int n_dm,
                   int t, int n_w, int k, int normalize, float* scratch,
                   cudaStream_t stream) {
  if (b <= 0 || n_dm <= 0 || n_w <= 0) return 0;
  if (t <= 0 || k <= 0 || k > kTopkMaxK) return int(cudaErrorInvalidValue);
  const int smem = scratch ? kTopkThreads * kTopkMaxK * 8 : topk_smem_bytes(t);
  cudaError_t e = cudaFuncSetAttribute(
      snr_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  Topk q;
  q.bank = bank;
  q.normalize = normalize;
  q.rows = static_cast<long long>(b) * n_dm;
  q.n_dm = n_dm;
  q.t = t;
  q.widths = widths;
  q.n_w = n_w;
  q.k = k;
  q.limit = limit;
  q.snr = snr;
  q.idx = idx;
  q.peak = peak;
  q.scratch = scratch;
  const long long cap = scratch ? kTopkScratchBlocks : (1LL << 30);
  const long long grid = q.rows < cap ? q.rows : cap;
  snr_topk_kernel<<<static_cast<unsigned>(grid), kTopkThreads, smem,
                    stream>>>(q);
  return int(cudaGetLastError());
}

int dsabf_median_rows(const float* x, float* out, long long rows, int n,
                      cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (n <= 0) return int(cudaErrorInvalidValue);
  const long long grid = rows < (1LL << 30) ? rows : (1LL << 30);
  median_rows_kernel<<<static_cast<unsigned>(grid), kTopkThreads, 0,
                       stream>>>(x, out, rows, n);
  return int(cudaGetLastError());
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
