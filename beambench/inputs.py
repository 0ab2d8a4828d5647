"""The inputs both sides get, made from ``--seed`` on the run's device.

- ``wire_block``: one 4R4I wire block (the capture's bytes): Gaussian
  voltages of ``inputs.noise_rms`` counts per component on the active
  antennas, rounded and clipped to the 4-bit range [-8, 7], zero in the
  padded slots (the wire contract); made with a ``torch.Generator`` on the
  device in a few large calls.
- ``steering_weights``: the complex steering weights ``[F, B, A_active]``
  complex128 from the array geometry (an east-west line at
  ``inputs.array_pitch_m``), the beam angles (uniform in sin(theta) over
  ``beam_span_deg``), the channel frequencies and a per-antenna phase drawn
  from the seed (the calibration's gain phase).

Plain PyTorch on the configuration file's numbers: the port hands these to
its own quantizer, the reference uses them in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_LIGHT_M_S = 299_792_458.0

#: Largest number of float32 samples drawn in one call.
_CHUNK = 1 << 28


def block_seed(seed: int, index: int) -> int:
    """The generator seed of block ``index`` of a run seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def wire_shape(obs: dict) -> tuple:
    t, f, p, a = obs["t_block"], obs["n_chan"], obs["n_pol"], obs["n_ant"]
    return (t, f, p, a) if obs["input_layout"] == "tfpa" else (f, t, p, a)


def block_duration_s(obs: dict) -> float:
    return obs["t_block"] * obs["n_chan_total"] / obs["bandwidth_hz"]


def wire_block(spec: dict, seed: int, index: int, device) -> torch.Tensor:
    """Block ``index`` of the run: uint8 ``wire_shape`` on ``device``."""
    obs = spec["obs"]
    rms = float(spec["inputs"]["noise_rms"])
    shape = wire_shape(obs)
    n_act = obs["n_ant_active"]
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, index))
    out = torch.zeros(shape, dtype=torch.uint8, device=device)
    per_row = math.prod(shape[1:3]) * n_act * 2
    rows = max(1, _CHUNK // per_row)
    for r0 in range(0, shape[0], rows):
        n = min(rows, shape[0] - r0)
        z = torch.randn((2, n, *shape[1:3], n_act), generator=gen,
                        device=device)
        q = z.mul_(rms).round_().clamp_(-8, 7).to(torch.int8).view(
            torch.uint8)
        out[r0:r0 + n, ..., :n_act] = ((q[0] & 0xF) << 4) | (q[1] & 0xF)
    return out


def steering_weights(spec: dict, seed: int, device) -> torch.Tensor:
    """``[F, B, A_active]`` complex128 weights on ``device``."""
    obs = spec["obs"]
    n_act = obs["n_ant_active"]
    df = obs["bandwidth_hz"] / obs["n_chan_total"]
    freqs = obs["f_start_hz"] + df * (torch.arange(
        obs["n_chan"], dtype=torch.float64, device=device) + 0.5)
    half = math.sin(math.radians(obs["beam_span_deg"] / 2.0))
    sin_theta = torch.linspace(-half, half, obs["n_beams"],
                               dtype=torch.float64, device=device)
    pitch = float(spec["inputs"]["array_pitch_m"])
    x = (torch.arange(n_act, dtype=torch.float64, device=device)
         - (n_act - 1) / 2.0) * pitch
    rng = np.random.default_rng([int(seed), 0x5EED])
    phi = torch.as_tensor(rng.uniform(0.0, 2.0 * math.pi, n_act),
                          dtype=torch.float64, device=device)
    turns = freqs[:, None, None] * (x[None, None, :]
                                    * sin_theta[None, :, None]
                                    / SPEED_OF_LIGHT_M_S)
    phase = -2.0 * math.pi * (turns - torch.round(turns)) + phi
    return torch.polar(torch.ones_like(phase), phase)
