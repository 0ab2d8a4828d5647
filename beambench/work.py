"""The work a block's deployed product needs, from the configuration's numbers.

Counted from what the product is, not from how the port computes it: the
complex multiply-accumulates of the beam sums over the *active* antennas
(not the contraction the kernel pads to, not its weight terms), four real
MACs each; and the bytes the product has to move once: the active
antennas' share of the wire read, each output written once (uint8 beam
powers, float32 incoherent power, float32 SK accumulators).  So a kernel
that issues fewer MACs, or drops padding, reads as closer to its roofline,
never as further.
"""

from __future__ import annotations


def complex_macs(obs: dict) -> int:
    """Complex MACs of one block's beam sums: F * T * P * B * A_active."""
    return (obs["n_chan"] * obs["t_block"] * obs["n_pol"] * obs["n_beams"]
            * obs["n_ant_active"])


def real_macs(obs: dict) -> int:
    return 4 * complex_macs(obs)


def bytes_moved(obs: dict) -> int:
    """Wire bytes of the active antennas read once, plus the products
    (uint8 power, float32 incoherent, float32 [F, 2] SK) written once."""
    f_out = obs["n_chan"] // obs["navg_freq"]
    t_out = obs["t_block"] // obs["navg_time"]
    wire = obs["t_block"] * obs["n_chan"] * obs["n_pol"] * obs["n_ant_active"]
    power = f_out * t_out * obs["n_beams"]
    inco = 4 * f_out * t_out
    sk = 4 * obs["n_chan"] * 2
    return wire + power + inco + sk


def least_time_s(obs: dict, peak: dict) -> tuple:
    """``(seconds, bound)``: the larger of the operations at the dense int8
    peak and the bytes at the memory bandwidth, and which one it is."""
    t_ops = real_macs(obs) / peak["int8_macs_per_s"]
    t_bytes = bytes_moved(obs) / peak["bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
