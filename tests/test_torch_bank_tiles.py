"""The dedispersion banks' kernel (``csrc/dedisperse.cu`` ``bank_kernel``,
which ``dedisperse_direct`` and ``subband_stage1`` launch), checked on the
CPU (it has no host form): its geometry as its source states it, where its register window serves a shift table and where it takes
per-trial loads (``bank_paths``), and its index arithmetic (staged rows
with their lead, each warp's window, each trial's offset) restated in
NumPy and held bit for bit against the plain versions."""

import numpy as np
import pytest
import torch

from dsabeamformer_tpu_torch.config import DSA10_COMPACT
from dsabeamformer_tpu_torch.ops import dedisperse as dd

LANE = dd.BANK_LANE_SAMPLES
WARP_TRIALS = dd.BANK_WARP_TRIALS
BLOCK_T = 32 * LANE
BLOCK_TRIALS = dd.BANK_WARPS * WARP_TRIALS
#: Floats of a staged row (kRow): the block's samples, its span, up to 3 of
#: lead and room for a window's last registers.
ROW = BLOCK_T + dd.BANK_BLOCK_SPAN + 4 + 8


def _dsa10c_tables():
    """The live monitor's delay table on the dsa10c window (465 trials to
    DM 100, 2048 channels) and its conv plan's stage-1 shifts."""
    f_mhz = DSA10_COMPACT.freqs_hz() / 1e6
    tsamp = DSA10_COMPACT.sample_period_s * DSA10_COMPACT.navg_time
    dms = dd.dm_trial_grid(float(f_mhz.min()), float(f_mhz.max()), tsamp,
                           dm_max=100.0)
    delays = dd.delay_table(f_mhz, dms, tsamp)
    intra, _, _, _ = dd._conv_plan(delays, dd._conv_auto_n_sub(delays), 1)
    return delays, intra


def test_bank_tiles_on_the_dsa10c_window():
    """The geometry ``csrc/dedisperse.cu`` states: trial tiles of 32 (a
    warp's 4), sample tiles of 480 (a lane's 15: odd, so that the 32 lanes'
    loads meet 32 banks); two stages of 16 rows of 552 floats, within the
    227 KB a block may have, with room in them for the sums on their way
    out.  On the dsa10c window: 15 trial tiles by 10 sample tiles a beam
    (direct), 4 by 12 a beam's channel group (stage 1)."""
    delays, intra = _dsa10c_tables()
    assert delays.shape == (465, 2048) and intra.shape == (16, 102, 128)
    assert (WARP_TRIALS, BLOCK_TRIALS, BLOCK_T, ROW) == (4, 32, 480, 552)
    assert LANE % 2 == 1
    smem = 2 * dd.BANK_CHUNK * ROW * 4
    assert smem == 70656 <= 227 * 1024
    assert BLOCK_TRIALS * BLOCK_T * 4 <= smem
    assert (-(-465 // BLOCK_TRIALS), -(-4708 // BLOCK_T)) == (15, 10)
    assert (-(-102 // BLOCK_TRIALS), -(-(4708 + 580) // BLOCK_T)) == (4, 12)


def test_window_serves_every_row_of_a_dm_sweep():
    """On the dsa10c window every (trial tile, warp, channel) of the direct
    bank and of every stage-1 group takes the register window: the steps
    between a warp's 4 consecutive trials are -1 .. 2 (direct: 0 .. 2;
    stage 1's rounded within-group shifts step back by one), a block's 32
    trials span at most 60 samples."""
    delays, intra = _dsa10c_tables()
    w = dd.bank_paths(delays)
    assert w.shape == (15, dd.BANK_WARPS, 2048)
    assert (w == dd.WINDOW_PATH).all()
    steps = np.diff(delays.astype(np.int64), axis=0)
    assert steps.min() == 0 and steps.max() == 2
    assert (np.diff(intra.astype(np.int64), axis=1).min()) == -1
    for g in range(intra.shape[0]):
        assert (dd.bank_paths(intra[g]) == dd.WINDOW_PATH).all()


def test_paths_of_wide_and_scattered_tables():
    """A random table (spans of hundreds of samples) takes per-trial global
    loads everywhere; on a table of 32 trials, rows where the trials step
    by 0 .. 2 take the window, rows where they step by 0 and 3 in turn
    (a span of 45) staged loads, rows spanning 124 global loads; a table
    that is not monotone but steps by -1 .. 2 keeps the window."""
    rng = np.random.default_rng(0)
    assert (dd.bank_paths(rng.integers(0, 600, (70, 33)))
            == dd.GLOBAL_PATH).all()
    d = np.arange(32)[:, None]
    table = np.concatenate([d * np.arange(3)[None, :] // 2,   # steps 0 .. 1
                            np.repeat(d // 2 * 3, 2, axis=1),  # 0, 3, 0, ...
                            d * 4], axis=1)                    # span 124
    w = dd.bank_paths(table)
    assert w.shape == (1, dd.BANK_WARPS, 6)
    assert (w[0, :, :3] == dd.WINDOW_PATH).all()
    assert (w[0, :, 3:5] == dd.STAGED_PATH).all()
    assert (w[0, :, 5] == dd.GLOBAL_PATH).all()
    walk = np.cumsum(rng.integers(-1, 3, 40))           # steps -1 .. 2
    zigzag = (walk - walk.min())[:, None] + np.zeros((1, 5), np.int64)
    assert (np.diff(zigzag, axis=0) < 0).any()
    assert (dd.bank_paths(zigzag) == dd.WINDOW_PATH).all()


def _bank_sum(p, table, t_out, vec=True):
    """The bank kernel's sums for one z, its index arithmetic restated:
    each block stages each row from ``t0 + s_min_block - lead`` (``lead``
    aligning the start to 16 bytes; zeros past T_pad), each warp reads at
    ``lead + s_min_warp - s_min_block + lane * LANE`` of the staged row,
    each trial ``LANE`` floats at its offset from ``s_min_warp``; a block
    span past 60 (or a warp's past 255) takes per-trial loads from the
    columns.  The adds in ascending row order from zero.  Returns the sums
    and the paths taken, ``bank_paths``' layout."""
    n_rows, t_pad = p.shape
    n_trials = table.shape[0]
    out = np.zeros((n_trials, t_out), np.float32)
    tiles = -(-n_trials // BLOCK_TRIALS)
    paths = np.zeros((tiles, dd.BANK_WARPS, n_rows), np.int8)
    lanes = np.arange(32)[:, None] * LANE + np.arange(LANE)[None, :]
    for tile in range(tiles):
        d0 = tile * BLOCK_TRIALS
        idx = np.minimum(np.arange(d0, d0 + BLOCK_TRIALS), n_trials - 1)
        tab = table[idx].astype(np.int64)                  # [32, rows]
        for t0 in range(0, t_out, BLOCK_T):
            acc = np.zeros((BLOCK_TRIALS, BLOCK_T), np.float32)
            for r in range(n_rows):
                s_min_b = int(tab[:, r].min())
                span_b = int(tab[:, r].max()) - s_min_b
                wide = [int(np.ptp(tab[w * WARP_TRIALS:(w + 1) * WARP_TRIALS,
                                       r])) >= 256
                        for w in range(dd.BANK_WARPS)]
                staged_ok = span_b <= dd.BANK_BLOCK_SPAN and not any(wide)
                start = t0 + s_min_b
                lead = start % 4 if vec else 0
                staged = np.full(ROW, np.nan, np.float32)
                n = max(0, min(ROW, t_pad - (start - lead)))
                staged[:n] = p[r, start - lead:start - lead + n]
                for w in range(dd.BANK_WARPS):
                    s = tab[w * WARP_TRIALS:(w + 1) * WARP_TRIALS, r]
                    steps = np.diff(s)
                    window = ((steps >= dd.BANK_MIN_STEP)
                              & (steps <= dd.BANK_MAX_STEP)).all()
                    paths[tile, w, r] = (
                        dd.GLOBAL_PATH if not staged_ok else
                        dd.WINDOW_PATH if window else dd.STAGED_PATH)
                    for j in range(WARP_TRIALS):
                        row = w * WARP_TRIALS + j
                        if staged_ok:
                            at = lead + int(s.min()) - s_min_b \
                                + int(s[j] - s.min()) + lanes
                            vals = staged[at]
                        else:
                            t = np.minimum(t0 + lanes, t_out - 1)
                            vals = p[r, t + s[j]]
                        acc[row] = (acc[row] + vals.reshape(-1)).astype(
                            np.float32)
            for k in range(BLOCK_TRIALS):
                if d0 + k < n_trials:
                    hi = min(BLOCK_T, t_out - t0)
                    out[d0 + k, t0:t0 + hi] = acc[k, :hi]
    return out, paths


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("kind", ["sweep", "random", "steep"])
def test_bank_index_arithmetic_equals_plain(kind, vec):
    """The restated kernel equals ``dedisperse_direct_plain`` bit for bit:
    a DM sweep (window), a random table (per-trial loads), a steep sweep
    (window, staged and global paths), 70 trials (a partial trial tile),
    300 samples (a partial sample tile), 20 rows (a partial chunk), T_pad a
    multiple of 4 (the wide copies) or not."""
    rng = np.random.default_rng({"sweep": 1, "random": 2, "steep": 3}[kind])
    n_trials, n_rows, t_out = 70, 20, 300
    if kind == "sweep":
        table = (np.arange(n_trials)[:, None] * (n_rows - np.arange(n_rows))
                 [None, :] // 15).astype(np.int32)
    elif kind == "random":
        table = rng.integers(0, 200, (n_trials, n_rows)).astype(np.int32)
    else:
        table = (np.arange(n_trials)[:, None] * np.arange(n_rows)[None, :]
                 // 3).astype(np.int32)
    t_pad = t_out + int(table.max())
    t_pad = -(-t_pad // 4) * 4 + (0 if vec else 1)
    p = rng.normal(size=(n_rows, t_pad)).astype(np.float32)
    want = dd.dedisperse_direct_plain(torch.from_numpy(p)[None],
                                      torch.from_numpy(table), t_out)[0]
    got, paths = _bank_sum(p, table, t_out, vec=vec and t_pad % 4 == 0)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(paths, dd.bank_paths(table))
