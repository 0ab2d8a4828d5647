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
//
// Each output sample is a float32 sum taken in ascending channel (group)
// order from zero with plain adds (__fadd_rn: nothing fused or reordered),
// so every kernel equals its plain PyTorch version and the reference's
// sequential scan bit for bit.
//
// What bounds it on the card: the adds (one per output sample per channel
// or group; FP32 outside the tensor cores), not the bytes: a block re-reads
// its beam's channel columns once per trial from L1/L2, and the data a
// window moves (its padded columns once, the bank once) is a few hundred MB.
// Design, simple first: a block owns (beam, 16 trials, 128 output samples),
// one output sample a thread with the 16 trials' sums in registers; it
// walks the channels, staging its trials' delay rows 256 channels at a time
// in shared memory (a broadcast read: every thread of a trial reads the same
// word), and each warp's reads of one channel at one trial's shift are 32
// consecutive floats of that channel's contiguous time series.  No tensor
// cores, TMA or pipelining: speed is a later change's.
//
// Plain C interface (no PyTorch headers), bound with ctypes; the wrapper
// checks shapes, types and devices, and the callers bound the shifts
// (0 <= shift, shift + outputs <= padded length).  Each entry point returns
// the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileT = 128;          // output samples a block owns
constexpr int kTileTrials = 16;      // trials (coarse trials) a block owns
constexpr int kStageChannels = 256;  // delay-row columns staged at a time

// The core of all three kernels: a block's kTileTrials sums of
// `data[row r][t + shift[k][r]]` over rows r in [0, n_rows), the rows
// `row_stride` floats apart, the shifts read as shift(k, r) from global
// memory (row-major with `shift_row` ints between trials, `shift_col`
// between rows) and staged in shared memory.
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
    direct_kernel(const float* __restrict__ p, const int* __restrict__ delays,
                  float* __restrict__ out, int n_chan, long long t_pad,
                  int n_dm, int t_out) {
  const int t = blockIdx.x * kTileT + threadIdx.x;
  const int d0 = blockIdx.y * kTileTrials;
  const int n_k = min(kTileTrials, n_dm - d0);
  const long long b = blockIdx.z;
  float acc[kTileTrials];
  sum_rows(p + b * n_chan * t_pad, t_pad, n_chan,
           delays + static_cast<long long>(d0) * n_chan, n_chan, 1, n_k, t,
           t < t_out, acc);
  if (t >= t_out) return;
  float* o = out + (b * n_dm + d0) * t_out + t;
#pragma unroll
  for (int k = 0; k < kTileTrials; ++k)
    if (k < n_k) o[static_cast<long long>(k) * t_out] = acc[k];
}

// grid (ceil(t1 / kTileT), ceil(n_coarse / kTileTrials), B * G)
__global__ void __launch_bounds__(kTileT)
    stage1_kernel(const float* __restrict__ p, const int* __restrict__ intra,
                  float* __restrict__ s, int n_grp, int n_cpg,
                  long long t_pad, int n_coarse, int t1) {
  const int t = blockIdx.x * kTileT + threadIdx.x;
  const int j0 = blockIdx.y * kTileTrials;
  const int n_k = min(kTileTrials, n_coarse - j0);
  const long long bg = blockIdx.z;  // b * G + g
  const long long g = bg % n_grp;
  float acc[kTileTrials];
  sum_rows(p + bg * n_cpg * t_pad, t_pad, n_cpg,
           intra + (g * n_coarse + j0) * n_cpg, n_cpg, 1, n_k, t, t < t1,
           acc);
  if (t >= t1) return;
  float* o = s + (bg * n_coarse + j0) * t1 + t;
#pragma unroll
  for (int k = 0; k < kTileTrials; ++k)
    if (k < n_k) o[static_cast<long long>(k) * t1] = acc[k];
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

dim3 grid_of(int n_t, int n_trials, long long n_z) {
  return dim3((n_t + kTileT - 1) / kTileT,
              (n_trials + kTileTrials - 1) / kTileTrials,
              static_cast<unsigned>(n_z));
}

}  // namespace

extern "C" {

int dsabf_dedisperse_direct(const float* p, const int* delays, float* out,
                            int b, int n_chan, long long t_pad, int n_dm,
                            int t_out, cudaStream_t stream) {
  if (b <= 0 || n_dm <= 0 || t_out <= 0) return 0;
  direct_kernel<<<grid_of(t_out, n_dm, b), kTileT, 0, stream>>>(
      p, delays, out, n_chan, t_pad, n_dm, t_out);
  return static_cast<int>(cudaGetLastError());
}

int dsabf_subband_stage1(const float* p, const int* intra, float* s, int b,
                         int n_grp, int n_cpg, long long t_pad, int n_coarse,
                         int t1, cudaStream_t stream) {
  if (b <= 0 || n_grp <= 0 || n_coarse <= 0 || t1 <= 0) return 0;
  stage1_kernel<<<grid_of(t1, n_coarse, static_cast<long long>(b) * n_grp),
                  kTileT, 0, stream>>>(p, intra, s, n_grp, n_cpg, t_pad,
                                       n_coarse, t1);
  return static_cast<int>(cudaGetLastError());
}

int dsabf_subband_stage2(const float* s, const int* offsets, float* out,
                         int b, int n_grp, long long plane, int n_dm,
                         int t_out, cudaStream_t stream) {
  if (b <= 0 || n_dm <= 0 || t_out <= 0) return 0;
  stage2_kernel<<<grid_of(t_out, n_dm, b), kTileT, 0, stream>>>(
      s, offsets, out, n_grp, plane, n_dm, t_out);
  return static_cast<int>(cudaGetLastError());
}

const char* dsabf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
