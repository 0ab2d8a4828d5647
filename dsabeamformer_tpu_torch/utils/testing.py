"""Tolerance harness: the <=1e-3 relative-power-error gate.

The same metric as ``dsabeamformer_tpu/utils/testing.py`` (NumPy only), so
the port and the JAX package gate on one number;
``tests/test_torch_config.py`` holds the two equal.  And the random
geometries that the CPU tests, the card tests and ``chip_smoke.py`` all
draw, so that each holds the same cases.
"""

from __future__ import annotations

import numpy as np

from dsabeamformer_tpu_torch.config import ObsConfig

#: The accuracy bar against the float64 golden model.
POWER_RTOL = 1e-3


def relative_power_error(p, p_ref) -> float:
    """Max relative power error with a floor tied to the block's peak
    power, so near-zero bins don't blow up the ratio."""
    p = np.asarray(p, dtype=np.float64)
    p_ref = np.asarray(p_ref, dtype=np.float64)
    if p.shape != p_ref.shape:
        raise ValueError(f"shape mismatch: {p.shape} vs {p_ref.shape}")
    scale = np.max(np.abs(p_ref))
    if scale == 0.0:
        return float(np.max(np.abs(p)))
    denom = np.maximum(np.abs(p_ref), 1e-3 * scale)
    return float(np.max(np.abs(p - p_ref) / denom))


def assert_power_close(p, p_ref, rtol: float = POWER_RTOL, what: str = ""):
    err = relative_power_error(p, p_ref)
    assert err <= rtol, (
        f"relative power error {err:.3e} > {rtol:.1e}" + (f" ({what})" if what else "")
    )
    return err


#: Weight mode of random geometry ``i`` (``i % 5``) and its bar against the
#: float64 golden model on a calibrated noise block.
FUZZ_MODES = ("int8x2", "int12", "f32", "bf16x2", "int13")
FUZZ_RTOL = {"int8x2": 3e-4, "int12": 2e-3, "f32": 1e-5, "bf16x2": 3e-4,
             "int13": 1e-3}
#: Seed of random geometry ``i`` is ``FUZZ_SEED + i``.
FUZZ_SEED = 1000


def random_geometry(i: int) -> tuple:
    """Random valid geometry ``i``: ``(cfg, tiles)``.

    The draws, in number and order, of the JAX package's
    ``tests/test_fuzz_geometry.py`` with the same seed, so both packages
    see the same case: antenna counts 8-32 (with zero padding and auto
    slicing: a_compute 8, 16, 24 or 32), 8-32 beams, navg_time 2-16, one to
    three averaging windows a block, navg_freq 1-2, both wire layouts, five
    weight modes.  ``tiles`` are the JAX config's Pallas tiling fields
    (``time_tile``, ``chan_tile``), which the port's config does not have."""
    rng = np.random.default_rng(FUZZ_SEED + i)
    navg_time = int(rng.choice([2, 4, 8, 16]))
    time_tile = navg_time * int(rng.choice([2, 4, 8]))
    t_block = time_tile * int(rng.choice([1, 2, 3]))
    chan_tile = int(rng.choice([1, 2, 4]))
    navg_freq = int(rng.choice([1, 2]))
    n_chan = chan_tile * navg_freq * int(rng.choice([1, 2, 3]))
    n_ant = int(rng.choice([8, 16, 24, 32]))
    n_ant_active = int(rng.integers(2, n_ant + 1))
    n_beams = int(rng.choice([8, 16, 32]))
    cfg = ObsConfig(
        name=f"fuzz{i}",
        n_ant=n_ant,
        n_ant_active=n_ant_active,
        n_beams=n_beams,
        n_chan=n_chan,
        n_chan_total=n_chan * int(rng.choice([1, 4])),
        t_block=t_block,
        navg_time=navg_time,
        navg_freq=navg_freq,
        weight_mode=FUZZ_MODES[i % len(FUZZ_MODES)],
        input_layout=str(rng.choice(["tfpa", "ftpa"])),
    )
    return cfg, {"time_tile": time_tile, "chan_tile": chan_tile}


#: Seed of odd-antenna geometry ``i`` is ``ODD_ANTS_SEED + i``.
ODD_ANTS_SEED = 2000


def random_geometry_odd_ants(i: int) -> ObsConfig:
    """Random valid geometry ``i`` whose antenna count is no multiple of 8
    (9 to 31; auto slicing, so a_compute is ``n_ant`` or a multiple of 16 or
    32 below it, and pol y's wire rows start off a 4-byte boundary where
    ``n_ant`` is no multiple of 4): 8-48 beams, navg_time 2-16, one to three
    averaging windows a block, navg_freq 1-2, both wire layouts, the five
    modes of ``FUZZ_MODES``.  Its own draws, so ``random_geometry``'s cases
    stay as they are."""
    rng = np.random.default_rng(ODD_ANTS_SEED + i)
    navg_time = int(rng.choice([2, 4, 8, 16]))
    t_block = navg_time * int(rng.choice([2, 4, 8])) \
        * int(rng.choice([1, 2, 3]))
    navg_freq = int(rng.choice([1, 2]))
    n_chan = navg_freq * int(rng.choice([1, 2, 3]))
    n_ant = int(rng.choice([a for a in range(9, 32) if a % 8]))
    return ObsConfig(
        name=f"odd{i}",
        n_ant=n_ant,
        n_ant_active=int(rng.integers(2, n_ant + 1)),
        n_beams=int(rng.choice([8, 20, 48])),
        n_chan=n_chan,
        n_chan_total=n_chan * int(rng.choice([1, 4])),
        t_block=t_block,
        navg_time=navg_time,
        navg_freq=navg_freq,
        weight_mode=FUZZ_MODES[i % len(FUZZ_MODES)],
        input_layout=str(rng.choice(["tfpa", "ftpa"])),
    )


#: The f32 split control's bar (``one_product_block``, navg_time 1):
#: relative power error of the f32 detect kernel against its plain version.
#: Each output is one sample of both pols, each voltage component one
#: product x * w.  The kernel adds the exact products of x and w's three
#: bf16 parts into float32, the plain version rounds x * w once, so they
#: differ by a few float32 units (at most 2.8e-7 of the power over 2e5
#: random weights, with round-to-nearest adds).  Without the third part a
#: weight misses up to 2^-17 of itself, and the power 2 Re(w* w3) / |w|^2:
#: a median of 2.5e-6 over the same weights, and above this bar for more
#: than half of them.
F32_SPLIT_RTOL = 2e-6


def one_product_block(cfg: ObsConfig, seed: int = 0) -> np.ndarray:
    """A wire block (``cfg.wire_block_shape``, uint8) in which only
    antenna 0 is live, its im nibbles 0 and its re nibbles random and not
    0: every beam voltage component is then one product, re x one weight,
    so a product that drops part of a weight shows at that part's size."""
    rng = np.random.default_rng(seed)
    wire = np.zeros(cfg.wire_block_shape, np.uint8)
    shape = wire.shape[:-1]
    re = rng.integers(1, 8, size=shape) * rng.choice([-1, 1], size=shape)
    wire[..., 0] = (re.astype(np.uint8) & 15) << 4
    return wire
