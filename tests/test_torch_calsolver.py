"""Port vs JAX package: the phase-up calibration solver
(``models/calsolver.py``) and ``dsabf-torch calibrate``, on the CPU at
``tiny``.

Bars: the solved complex64 gains within ``GAINS_RTOL`` of JAX's on the same
wire (relative to each gain's magnitude; the sums are complex128 in both,
only their order differs); the JAX package's own bars
(tests/test_calsolver.py) on the port; the CLI's record equal to the JAX
CLI's (its floats within ``GAINS_RTOL``) and each package's table usable
by the other's ``run --cal``, products within ``POWER_RTOL``
(tests/test_torch_pipeline.py's bar)."""

import json
import os

import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu.models import calsolver as jsolver
from dsabeamformer_tpu.models.arrays import array_for as jarray_for
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import TINY, ObsConfig
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.generator import make_point_source_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.calsolver import (
    solve_gains,
    solve_gains_blocks,
)
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.gemm import beamform_power
from dsabeamformer_tpu_torch.ops.quantize import quantize_weights
from dsabeamformer_tpu_torch.utils.testing import (
    POWER_RTOL,
    relative_power_error,
)

#: Port vs JAX gains, relative.
GAINS_RTOL = 1e-6


def _corrupted_calibrator(cfg, angle, seed=3, noise_rms=0.15):
    """tests/test_calsolver.py's calibrator: gains 1 +- 0.15 in amplitude,
    phase sigma 1.5 rad, amplitude 2.5 (below the 4-bit clip)."""
    rng = np.random.default_rng(seed)
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    amp = 1.0 + 0.15 * rng.standard_normal((act, cfg.n_chan))
    ph = 1.5 * rng.standard_normal((act, cfg.n_chan))
    g[:act] = amp * np.exp(1j * ph)
    wire = make_point_source_block(cfg, angle, amplitude=2.5,
                                   noise_rms=noise_rms, seed=seed,
                                   instrumental_gains=g)
    return wire, g


def _jcfg(cfg: ObsConfig, **tiles):
    """The JAX package's config of the same geometry (``tiles``: its TPU
    tile fields, which the port has not)."""
    if cfg.name == "tiny":
        return jcfg.TINY.replace(input_layout=cfg.input_layout)
    return jcfg.ObsConfig(**tiles, **{f: getattr(cfg, f) for f in (
        "name", "n_ant", "n_ant_active", "n_beams", "n_chan", "n_chan_total",
        "t_block", "navg_time", "f_start_hz", "bandwidth_hz",
        "input_layout")})


def _assert_gains_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    act = np.abs(want) > 0
    assert not np.any(got[~act])
    rel = np.abs(got[act] - want[act]) / np.abs(want[act])
    assert rel.max() <= GAINS_RTOL, rel.max()


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("ref_ant", [0, 4])
def test_solve_gains_matches_jax(layout, ref_ant):
    cfg = TINY.replace(input_layout=layout)
    angle = cfg.beam_angles_rad()[20]
    wire, _ = _corrupted_calibrator(cfg, angle)
    got = solve_gains(wire, cfg, angle, ref_ant=ref_ant, device="cpu")
    want = jsolver.solve_gains(wire, _jcfg(cfg), angle, ref_ant=ref_ant)
    _assert_gains_close(got.gains, want.gains)


def test_solve_gains_blocks_matches_jax():
    cfg = TINY
    angle = cfg.beam_angles_rad()[10]
    blocks = [_corrupted_calibrator(cfg, angle, seed=s, noise_rms=0.6)[0]
              for s in range(3)]
    # Host arrays, CPU tensors and the device wire form all read alike.
    mixed = [blocks[0], torch.from_numpy(blocks[1]),
             torch.from_numpy(blocks[2]).reshape(cfg.device_wire_shape)]
    got = solve_gains_blocks(mixed, cfg, angle, device="cpu")
    want = jsolver.solve_gains_blocks(blocks, _jcfg(cfg), angle)
    _assert_gains_close(got.gains, want.gains)


def test_solver_refusals_match_jax():
    cfg = TINY
    for kw in ({"ref_ant": cfg.n_ant_active}, {"ref_ant": -1}):
        with pytest.raises(ValueError, match="not an active antenna"):
            solve_gains_blocks([], cfg, 0.0, device="cpu", **kw)
        with pytest.raises(ValueError, match="not an active antenna"):
            jsolver.solve_gains_blocks([], _jcfg(cfg), 0.0, **kw)
    with pytest.raises(ValueError, match="no blocks given"):
        solve_gains_blocks([], cfg, 0.0, device="cpu")


def test_even_count_median_is_the_mean_of_the_middle_two():
    """|g_rel| has 48 values at tiny (8 channels x 6 antennas): NumPy's
    median is the mean of the two middle ones.  The instrument's amplitudes
    are 0.6 on the reference antenna, 0.75 on antennas 1-2 and 1.05 on 3-5,
    so |g_rel| is 1 (8 values), ~1.25 (16) and ~1.75 (24): the middle two
    are ~1.25 and ~1.75, and a lower-middle median (``torch.median``'s)
    would miss JAX's table by ~17%; the port's meets it."""
    cfg = TINY
    angle = cfg.beam_angles_rad()[20]
    rng = np.random.default_rng(9)
    act = cfg.n_ant_active
    amp = np.array([0.6, 0.75, 0.75, 1.05, 1.05, 1.05])[:, None]
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = amp * np.exp(1.5j * rng.standard_normal((act, cfg.n_chan)))
    wire = make_point_source_block(cfg, angle, amplitude=2.5, noise_rms=0.15,
                                   seed=9, instrumental_gains=g)
    jc = _jcfg(cfg)
    r, auto = jsolver._accumulate_block(wire, jc, angle, jarray_for(jc), 0)
    mags = np.sort(np.abs(r / np.maximum(auto[:, None], 1e-30)).ravel())
    n = mags.size
    assert n % 2 == 0 and n == cfg.n_chan * cfg.n_ant_active
    lo, hi = mags[n // 2 - 1], mags[n // 2]
    median = np.median(mags)
    assert median == (lo + hi) / 2
    assert float(torch.median(torch.from_numpy(mags))) == lo
    # The table scales with the median: a lower-middle one is off by
    # |lo / median - 1| everywhere, far outside the bar.
    assert abs(lo / median - 1.0) > 0.1
    want = jsolver.solve_gains(wire, jc, angle).gains
    with pytest.raises(AssertionError):
        _assert_gains_close((want * np.float32(lo / median)).astype(
            np.complex64), want)
    _assert_gains_close(solve_gains(wire, cfg, angle, device="cpu").gains,
                        want)


def test_solved_gains_invert_instrument():
    cfg = TINY
    angle = cfg.beam_angles_rad()[20]
    wire, g = _corrupted_calibrator(cfg, angle)
    cal = solve_gains(wire, cfg, angle, device="cpu")
    act = cfg.n_ant_active
    prod = cal.gains[:act] * g[:act]
    rel = prod / prod[0:1]
    np.testing.assert_allclose(np.abs(rel), 1.0, atol=0.15)
    assert np.abs(np.angle(rel)).max() < 0.08


def _power(cfg, wire, cal=None):
    qw = quantize_weights(make_weights(cfg, cal=cal, device="cpu"),
                          cfg.weight_mode, cfg.a_compute)
    return beamform_power(torch.from_numpy(wire), qw, cfg).numpy().sum(
        axis=(0, 1))


def test_solved_cal_restores_beam():
    cfg = TINY
    target = 20
    angle = cfg.beam_angles_rad()[target]
    wire, _ = _corrupted_calibrator(cfg, angle)
    p_raw = _power(cfg, wire)
    p_cal = _power(cfg, wire, solve_gains(wire, cfg, angle, device="cpu"))
    assert int(np.argmax(p_cal)) == target
    clean = make_point_source_block(cfg, angle, amplitude=2.5,
                                    noise_rms=0.15, seed=3)
    p_ref = _power(cfg, clean)
    assert p_cal[target] > 0.8 * p_ref[target]
    assert p_cal[target] > 1.5 * p_raw[target]


def test_multi_block_solve_tightens():
    cfg = TINY
    angle = cfg.beam_angles_rad()[10]
    act = cfg.n_ant_active
    rng = np.random.default_rng(7)
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = np.exp(1j * rng.standard_normal((act, cfg.n_chan)))
    blocks = [make_point_source_block(cfg, angle, amplitude=3.0,
                                      noise_rms=0.8, seed=s,
                                      instrumental_gains=g)
              for s in range(4)]

    def phase_err(cal):
        prod = cal.gains[:act] * g[:act]
        return np.abs(np.angle(prod / prod[0:1])).max()

    e1 = phase_err(solve_gains(blocks[0], cfg, angle, device="cpu"))
    e4 = phase_err(solve_gains_blocks(blocks, cfg, angle, device="cpu"))
    assert e4 < e1


@pytest.mark.parametrize("i", range(3))
def test_solver_fuzz_geometry(i):
    """tests/test_calsolver.py's random geometries: phases within 0.1 rad
    whatever the array shape, and the table equal to JAX's."""
    rng = np.random.default_rng(400 + i)
    n_ant = int(rng.choice([8, 16, 32]))
    cfg = ObsConfig(
        name=f"calfuzz{i}",
        n_ant=n_ant,
        n_ant_active=int(rng.integers(3, n_ant + 1)),
        n_beams=16,
        n_chan=int(rng.choice([4, 8])),
        n_chan_total=8,
        t_block=256,
        navg_time=16,
    )
    act = cfg.n_ant_active
    g = np.zeros((cfg.n_ant, cfg.n_chan), np.complex128)
    g[:act] = np.exp(1j * rng.uniform(-np.pi, np.pi, (act, cfg.n_chan)))
    angle = float(rng.uniform(-0.02, 0.02))
    wire = make_point_source_block(cfg, angle, amplitude=2.5,
                                   noise_rms=0.2, seed=i,
                                   instrumental_gains=g)
    cal = solve_gains(wire, cfg, angle, device="cpu")
    prod = cal.gains[:act] * g[:act]
    rel = prod / prod[0:1]
    assert np.abs(np.angle(rel)).max() < 0.1
    _assert_gains_close(cal.gains,
                        jsolver.solve_gains(wire, _jcfg(cfg, time_tile=64,
                                                        chan_tile=2),
                                            angle).gains)


# --------------------------- dsabf-torch calibrate ----------------------- #

def _main(which, argv, capsys):
    capsys.readouterr()
    rc = which.main(argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


def _assert_records_equal(j: dict, p: dict) -> None:
    assert set(j) == set(p)
    for k in j:
        if k == "out":
            continue
        if isinstance(j[k], float):
            assert p[k] == pytest.approx(j[k], rel=GAINS_RTOL, abs=1e-7), k
        else:
            assert p[k] == j[k], k


def _cal_capture(path, cfg, angle_deg, seeds=(0, 1)):
    dada.write_dada_file(path, cfg, (
        make_point_source_block(cfg, np.deg2rad(angle_deg), amplitude=2.5,
                                noise_rms=0.2, seed=s) for s in seeds))
    return str(path)


def test_cli_calibrate_from_a_file_matches_jax(tmp_path, capsys):
    """The same record and table as the JAX CLI's; each package's table
    drives the other's ``run --cal``, products equal to the own table's."""
    cfg = TINY
    angle_deg = float(np.rad2deg(cfg.beam_angles_rad()[10]))
    cap = _cal_capture(tmp_path / "cal.dada", cfg, angle_deg)
    recs, tables = {}, {}
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{which.__name__.split('.')[0]}.npz")
        rc, stdout, _ = _main(which, ["calibrate", "--config", "tiny",
                                      "--input-file", cap, "--angle",
                                      str(angle_deg), "--out", out,
                                      "--ref-ant", "1"] + extra, capsys)
        assert rc == 0
        recs[which] = json.loads(stdout)
        assert recs[which]["out"] == out
        tables[which] = out
    _assert_records_equal(recs[jcli], recs[pcli])
    assert recs[pcli]["blocks"] == 2
    assert abs(recs[pcli]["median_amp"] - 1.0) < 0.1
    assert recs[pcli]["max_phase_rad"] < 0.1
    # Each package loads the other's table.
    _assert_gains_close(JCal.load(tables[pcli]).gains,
                        CalTable.load(tables[jcli]).gains)
    # And runs with it: JAX run --cal <port table> == JAX run --cal <JAX
    # table>, and the port's run the same way round.
    prods = {}
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        for owner, table in tables.items():
            pout = str(tmp_path / f"p_{which.__name__.split('.')[0]}_"
                       f"{owner.__name__.split('.')[0]}.raw")
            rc, _, _ = _main(which, ["run", "--config", "tiny",
                                     "--input-file", cap, "--cal", table,
                                     "--output-file", pout] + extra, capsys)
            assert rc == 0
            prods[which, owner] = np.fromfile(pout, np.float32)
    for which in (jcli, pcli):
        a, b = prods[which, jcli], prods[which, pcli]
        assert a.size and a.shape == b.shape
        assert relative_power_error(b, a) <= POWER_RTOL
    assert relative_power_error(prods[pcli, jcli], prods[jcli, jcli]) \
        <= POWER_RTOL


def test_cli_calibrate_from_a_ring_matches_jax(capsys, tmp_path):
    """``calibrate --key``: the blocks of a live ring (the port's read on
    ``--device cpu``), the same record and table as the JAX CLI's."""
    from dsabeamformer_tpu.ingest.ring import RingBuffer as JaxRing
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    cfg = TINY
    angles = cfg.beam_angles_rad()
    angle_deg = float(np.rad2deg(angles[cfg.n_beams // 2]))
    blocks = [make_point_source_block(cfg, angles[cfg.n_beams // 2],
                                      noise_rms=0.3, seed=s)
              for s in range(2)]
    recs, tables = {}, {}
    for which, ring_cls, extra in ((jcli, JaxRing, []),
                                   (pcli, RingBuffer, ["--device", "cpu"])):
        key = f"tcal{os.getpid()}{which is pcli:d}"
        out = str(tmp_path / f"{which.__name__.split('.')[0]}.npz")
        with ring_cls(key, create=True, nbufs=4,
                      bufsz=cfg.wire_block_bytes) as ring:
            ring.write_header(dada.encode_header(cfg))
            for b in blocks:
                ring.write_block(b)
            ring.set_eod()
            rc, stdout, _ = _main(which, ["calibrate", "--config", "tiny",
                                          "--key", key, "--blocks", "2",
                                          "--timeout", "2", "--angle",
                                          str(angle_deg), "--out", out]
                                  + extra, capsys)
        assert rc == 0
        recs[which] = json.loads(stdout.strip().splitlines()[-1])
        tables[which] = out
    _assert_records_equal(recs[jcli], recs[pcli])
    assert recs[pcli]["blocks"] == 2
    assert recs[pcli]["n_ant_active"] == cfg.n_ant_active
    _assert_gains_close(CalTable.load(tables[pcli]).gains,
                        JCal.load(tables[jcli]).gains)


def test_cli_calibrate_refusals_match_jax(tmp_path, capsys):
    """Neither or both inputs: exit 2; an empty capture: exit 1 with the
    same message."""
    empty = tmp_path / "empty.raw"
    empty.write_bytes(b"")
    base = ["calibrate", "--config", "tiny", "--angle", "0", "--out",
            str(tmp_path / "c.npz")]
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        assert _main(which, base + extra, capsys)[0] == 2
        assert _main(which, base + ["--input-file", str(empty), "--key",
                                    "x"] + extra, capsys)[0] == 2
        rc, out, err = _main(which, base + ["--input-file", str(empty)]
                             + extra, capsys)
        assert rc == 1 and out == "" and err.startswith("no blocks in")
    assert not (tmp_path / "c.npz").exists()
