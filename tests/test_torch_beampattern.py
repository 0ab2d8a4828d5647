"""Port vs JAX package: ``models/beampattern.py`` (``beam_response``,
``beam_fwhm_rad``) on the CPU, and ``dsabf-torch beampattern``.

Bars: the responses within ``RESPONSE_RTOL`` of JAX's relative to their
peak (the same float64 / complex128 arithmetic, in the same order of
operations); ``beam_fwhm_rad`` equal; the JAX package's own physics bars
(tests/test_beampattern.py) on the port."""

import json
import sys

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.models.beampattern as jb
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.models.beampattern as pb
from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu.models.arrays import ArrayLayout as JLayout
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

RESPONSE_RTOL = 1e-12

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_16ch": (jcfg.DSA10.replace(n_chan=16), pcfg.DSA10.replace(n_chan=16)),
    "dsa110_8ch": (jcfg.DSA110.replace(n_chan=8), pcfg.DSA110.replace(n_chan=8)),
}


def _sweep(cfg, n=97):
    half = np.deg2rad(cfg.beam_span_deg * 0.75)
    return np.linspace(-half, half, n)


@pytest.mark.parametrize("chan", [None, 0, 3])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_beam_response_matches_jax(geom, chan):
    jc, pc = GEOMS[geom]
    sweep = _sweep(pc)
    got = pb.beam_response(pc, sweep, chan=chan, device="cpu")
    want = jb.beam_response(jc, sweep, chan=chan)
    assert got.dtype == np.float64 and got.shape == want.shape \
        == (len(sweep), pc.n_beams)
    assert relative_power_error(got, want) <= RESPONSE_RTOL


def test_beam_response_custom_layout_matches_jax():
    rng = np.random.default_rng(11)
    pc, jc = pcfg.TINY, jcfg.TINY
    x = np.zeros(pc.n_ant)
    x[: pc.n_ant_active] = np.sort(rng.uniform(-30, 30, pc.n_ant_active))
    sweep = _sweep(pc, 61)
    got = pb.beam_response(pc, sweep, device="cpu",
                           layout=ArrayLayout(positions_m=x,
                                              n_active=pc.n_ant_active))
    want = jb.beam_response(jc, sweep, layout=JLayout(
        positions_m=x, n_active=jc.n_ant_active))
    assert relative_power_error(got, want) <= RESPONSE_RTOL


def test_beam_response_chunks_over_channels(monkeypatch):
    """Summed a few channels at a time, the response is the whole band's
    (the chunking that bounds memory at full width)."""
    pc = pcfg.DSA10.replace(n_chan=16)
    sweep = _sweep(pc, 33)
    whole = pb.beam_response(pc, sweep, device="cpu")
    monkeypatch.setattr(pb, "_CHUNK_ELEMENTS", 3 * len(sweep) * pc.n_beams)
    chunked = pb.beam_response(pc, sweep, device="cpu")
    assert relative_power_error(chunked, whole) <= RESPONSE_RTOL


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_beam_fwhm_equal(geom):
    jc, pc = GEOMS[geom]
    assert pb.beam_fwhm_rad(pc) == jb.beam_fwhm_rad(jc)


def test_matched_beams_on_diagonal():
    angles = pcfg.TINY.beam_angles_rad()
    resp = pb.beam_response(pcfg.TINY, angles, device="cpu")
    np.testing.assert_array_equal(np.argmax(resp, axis=1),
                                  np.arange(len(angles)))
    np.testing.assert_allclose(np.diag(resp), 1.0, atol=1e-6)


def test_off_axis_suppression():
    cfg = pcfg.TINY
    far = cfg.beam_angles_rad()[0] + 5 * pb.beam_fwhm_rad(cfg)
    assert pb.beam_response(cfg, np.array([far]), device="cpu")[0, 0] < 0.5


def test_fwhm_matches_analytic():
    cfg = pcfg.TINY
    angles = cfg.beam_angles_rad()
    b = len(angles) // 2
    est = pb.beam_fwhm_rad(cfg)
    sweep = angles[b] + np.linspace(-3, 3, 601) * est
    resp = pb.beam_response(cfg, sweep, device="cpu")[:, b]
    above = sweep[resp >= 0.5 * resp.max()]
    assert 0.7 < (above.max() - above.min()) / est < 1.3


def test_cli_beampattern_writes_a_png(tmp_path, capsys):
    """The same record as the JAX CLI's, and a PNG from each."""
    recs = []
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        out = tmp_path / f"{which.__name__.split('.')[0]}.png"
        capsys.readouterr()
        rc = which.main(["beampattern", "--config", "tiny", "--out", str(out),
                         "--sweep", "64"] + extra)
        assert rc == 0
        rec = json.loads(capsys.readouterr().out)
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        recs.append({k: v for k, v in rec.items() if k != "out"})
        assert rec["out"] == str(out)
    assert recs[0] == recs[1] == {"beams": 32}


def test_cli_beampattern_without_matplotlib(tmp_path, capsys, monkeypatch):
    """No matplotlib: exit 2, one stderr line naming it, no traceback, no
    file."""
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "b.png"
    capsys.readouterr()
    rc = pcli.main(["beampattern", "--config", "tiny", "--out", str(out),
                    "--device", "cpu"])
    got = capsys.readouterr()
    assert rc == 2 and got.out == ""
    lines = got.err.strip().splitlines()
    assert len(lines) == 1 and "matplotlib" in lines[0]
    assert "Traceback" not in got.err
    assert not out.exists()
