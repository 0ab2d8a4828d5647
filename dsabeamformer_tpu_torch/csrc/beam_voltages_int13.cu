// The voltage kernel of the int13 weight mode: beam_voltages.cu's kernels
// with four int8 sub-terms per channel, exported as
// dsabf_beam_voltages_int13 (see detect_power_int13.cu).
//
// Replaces: the Pallas TPU kernel dsabeamformer_tpu/ops/gemm.py::
//   _voltage_kernel (gemm.py:427, pl.pallas_call gemm.py:932) with x_dup.
//   What bounds it and what the design does about it: see beam_voltages.cu.

#define DSABF_INT13 1
#include "beam_voltages.cu"
