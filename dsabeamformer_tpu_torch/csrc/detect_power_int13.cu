// The detect kernel of the int13 weight mode: detect_power.cu's kernels with
// four int8 sub-terms per channel ([[h1], [l1], [h2], [l2]] along K,
// combined as (M_h1 + M_h2) * 16 + (M_l1 + M_l2)), exported as
// dsabf_detect_power_int13.  A source of its own so that its compiler runs
// beside the others'.
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _fused_detect (pl.pallas_call, gemm.py:775) with x_dup (int13's operand
//   [X12 | X12], _build_x gemm.py:109-118).  What bounds it and what the
//   design does about it: see detect_power.cu.

#define DSABF_INT13 1
#include "detect_power.cu"
