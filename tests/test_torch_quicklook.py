"""The port's quick-look tools (``utils/quicklook.py``, ``dsabf-torch
waterfall`` and ``fold``) against the JAX package's on the CPU.  Both are
host NumPy, so every result must be EQUAL: each function on the same seeded
inputs (the cases of ``tests/test_quicklook.py``), the loaders on ``.fil``
(32- and 8-bit, 4-IF Stokes), power, Stokes and incoherent ``.dada``
products written by each package's ``run``, and the two CLIs' stdout,
stderr, exit codes and PGM bytes on the same product file.  The drills
(``simulate --pulse-dm`` / ``--pulse-period`` -> ``run`` -> ``waterfall`` /
``fold``) run through the port's commands end to end."""

import json

import numpy as np
import pytest

import dsabeamformer_tpu.utils.quicklook as JQ
import dsabeamformer_tpu_torch.utils.quicklook as PQ
from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import DM_CONST_S, TINY
from dsabeamformer_tpu_torch.ingest.sigproc import _encode_header_dict
from test_torch_cli import _main

NAVG2 = ["--set", "navg_time=2"]
CFG2 = TINY.replace(navg_time=2)


def _pulse_dm(cfg, span_samples):
    """DM whose band-edge delay spans ``span_samples`` output samples."""
    f = cfg.freqs_hz() / 1e6
    tsamp = cfg.sample_period_s * cfg.navg_time
    return span_samples * tsamp / (DM_CONST_S * (f.min() ** -2
                                                 - f.max() ** -2))


def _same(call, *args, **kwargs):
    """``call`` from both modules on the same arguments: equal results, or
    the same exception type and message."""
    got = []
    for mod in (JQ, PQ):
        try:
            got.append(("ok", getattr(mod, call)(*args, **kwargs)))
        except Exception as e:  # noqa: BLE001 - compared below
            got.append(("err", (type(e), str(e))))
    (kj, j), (kp, p) = got
    assert kj == kp, got
    if kj == "err":
        assert p == j
        return None
    _assert_equal(p, j)
    return p


def _assert_equal(p, j):
    if isinstance(j, tuple):
        assert isinstance(p, tuple) and len(p) == len(j)
        for a, b in zip(p, j):
            _assert_equal(a, b)
    elif isinstance(j, np.ndarray):
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(p, j)
    elif isinstance(j, list):
        assert len(p) == len(j)
        for a, b in zip(p, j):
            _assert_equal(a, b)
    else:
        assert p == j


# ----------------------------- the functions ------------------------------ #

def test_names_and_constants():
    assert PQ.__all__ == JQ.__all__
    assert PQ.ASCII_RAMP == JQ.ASCII_RAMP
    assert PQ._STOKES_INDEX == JQ._STOKES_INDEX
    assert PQ.DM_CONST_S == JQ.DM_CONST_S


def _hot():
    x = np.zeros((37, 53))
    x[19, 30] = 1000.0
    return x


@pytest.mark.parametrize("x,rows,cols", [
    (np.random.default_rng(0).uniform(0, 5, (37, 53)), 8, 7),
    (_hot(), 8, 7),
    (np.arange(12.0).reshape(3, 4), 100, 100),
    (np.random.default_rng(1).normal(size=(300, 64)), 32, 78),
    (np.zeros((0, 4)), 8, 8),
    (np.zeros(5), 8, 8),
])
def test_downsample_mean(x, rows, cols):
    got = _same("downsample_mean", x, rows, cols)
    if got is not None and x.shape == (37, 53):
        tb = np.linspace(0, 37, rows + 1).astype(int)
        fb = np.linspace(0, 53, cols + 1).astype(int)
        counts = np.diff(tb)[:, None] * np.diff(fb)[None, :]
        np.testing.assert_allclose((got * counts).sum(), x.sum(),
                                   rtol=1e-12)


def _rfi():
    x = np.ones((10, 10))
    x[0, 0] = 1e9
    return x


def _nan_inf():
    x = np.outer(np.arange(10.0), np.ones(10))
    x[3, 3], x[4, 4] = np.nan, np.inf
    return x


@pytest.mark.parametrize("x,clip", [
    (_rfi(), (1.0, 99.0)),
    (np.full((4, 4), 7.0), (1.0, 99.0)),
    (_nan_inf(), (1.0, 99.0)),
    (np.random.default_rng(2).normal(size=(20, 30)), (5.0, 80.0)),
    (np.full((3, 3), np.nan), (1.0, 99.0)),
])
def test_percentile_scale(x, clip):
    got = _same("percentile_scale", x, *clip)
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1


@pytest.mark.parametrize("ramp", [None, "ab", " .:-=+*#%@"])
def test_render_ascii(ramp):
    scaled = np.concatenate([np.array([[0.0, 0.5], [0.999, 1.0]]),
                             np.random.default_rng(3).uniform(0, 1, (5, 2))])
    args = (scaled,) if ramp is None else (scaled, ramp)
    got = _same("render_ascii", *args)
    lines = got.split("\n")
    assert len(lines) == 7 and lines[0][0] == (ramp or PQ.ASCII_RAMP)[0]


def test_write_pgm(tmp_path):
    scaled = np.random.default_rng(4).uniform(0, 1, (9, 13))
    JQ.write_pgm(tmp_path / "j.pgm", scaled)
    PQ.write_pgm(tmp_path / "p.pgm", scaled)
    raw = (tmp_path / "p.pgm").read_bytes()
    assert raw == (tmp_path / "j.pgm").read_bytes()
    assert raw.startswith(b"P5\n13 9\n255\n")


def _aligned_pulse():
    meta = {"f_lo_mhz": 1280.0, "f_hi_mhz": 1530.0, "tsamp_s": 1e-3}
    t, nf, dm, t0 = 256, 32, 50.0, 10
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], nf)
    shifts = np.rint(DM_CONST_S * dm * (freqs**-2 - meta["f_hi_mhz"]**-2)
                     / meta["tsamp_s"]).astype(int)
    x = np.ones((t, nf))
    for c, s in enumerate(shifts):
        x[t0 + s, c] = 100.0
    return x, meta, dm


@pytest.mark.parametrize("case", ["true_dm", "dm0", "noise", "negative",
                                  "no_tsamp", "long_sweep"])
def test_dedisperse(case):
    x, meta, dm = _aligned_pulse()
    if case == "dm0":
        dm = 0.0
    elif case == "noise":
        x = np.random.default_rng(5).normal(size=x.shape)
    elif case == "negative":
        dm = -1.0
    elif case == "no_tsamp":
        meta = {"f_lo_mhz": 1.0, "f_hi_mhz": 2.0}
    elif case == "long_sweep":
        dm = 5000.0  # shifts past the end: median-filled channels
    got = _same("dedisperse", x, meta, dm)
    if case == "true_dm":
        assert (got[10] == 100.0).all() and (got == 100.0).sum() == 32
    elif case == "dm0":
        np.testing.assert_array_equal(got, x)
    elif case in ("negative", "no_tsamp"):
        assert got is None


def _pulsar(t=4000, f=32, period=0.05, tsamp=1e-3, phase=0.3, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, f)).astype(np.float32)
    for k in range(int(t * tsamp / period)):
        t0 = int(round((k + phase) * period / tsamp))
        if t0 < t:
            x[t0] += 3.0
    return x


@pytest.mark.parametrize("period,bins", [
    (0.05, 25), (0.05 * 1.37, 25), (0.05, 1000), (0.0005, 25),
    (0.05, 1), (3.0, 25)])
def test_fold_spectrogram_and_profile_snr(period, bins):
    x = _pulsar()
    got = _same("fold_spectrogram", x, 1e-3, period, n_bins=bins)
    if got is None:
        return
    prof, counts = got
    assert counts.sum() == x.shape[0]
    snr, peak = _same("profile_snr", prof)
    _same("profile_snr", prof, 0.25)
    if (period, bins) == (0.05, 25):
        assert snr > 20 and abs((peak + 0.5) / prof.shape[0] - 0.3) < 0.1
    if bins == 1000:
        assert prof.shape[0] == 50


def test_profile_snr_flat():
    _same("profile_snr", np.ones((8, 4)))


# ------------------------- loaders on both runs' products ----------------- #

@pytest.fixture(scope="module")
def products(tmp_path_factory):
    """One capture (a dispersed pulse) beamformed by each package's ``run``
    into every product kind: {"jax" | "port": {kind: path}}."""
    d = tmp_path_factory.mktemp("products")
    dm = _pulse_dm(CFG2, 16)
    cap = d / "cap.dada"
    assert jcli.main(["simulate", "--config", "tiny", *NAVG2, "--pulse-dm",
                      str(dm), "--pulse-t0", "8", "--pulse-width", "6",
                      "--blocks", "4", "--distinct", "2", "--out-file",
                      str(cap)]) == 0
    out = {}
    for name, which, extra in (("jax", jcli, []),
                               ("port", pcli, ["--device", "cpu"])):
        p = d / name
        p.mkdir()
        runs = {
            ("power", "inco"): ["--output-file", str(p / "power.dada"),
                                "--incoherent-file", str(p / "inco.dada")],
            ("fil32",): ["--fil-dir", str(p / "fil32"), "--fil-bits", "32"],
            ("fil8",): ["--fil-dir", str(p / "fil8"), "--fil-bits", "8"],
            ("stokes",): ["--products", "stokes", "--output-file",
                          str(p / "stokes.dada")],
            ("stokes_fil",): ["--products", "stokes", "--fil-dir",
                              str(p / "sfil"), "--fil-bits", "32"],
        }
        for argv in runs.values():
            assert which.main(["run", "--config", "tiny", *NAVG2,
                               "--input-file", str(cap), *argv,
                               *extra]) == 0
        out[name] = {
            "power": p / "power.dada", "inco": p / "inco.dada",
            "fil32": p / "fil32" / "beam0003.fil",
            "fil8": p / "fil8" / "beam0016.fil",
            "stokes": p / "stokes.dada",
            "stokes_fil": p / "sfil" / "beam0002.fil",
        }
    out["dm"] = dm
    return out


LOAD_CASES = [
    ("power", {}), ("power", {"beam": 16}), ("power", {"beam": 99}),
    ("power", {"stokes": "Q"}), ("power", {"stokes": "X"}),
    ("inco", {}), ("inco", {"beam": 1}), ("inco", {"stokes": "V"}),
    ("fil32", {}), ("fil32", {"stokes": "V"}), ("fil8", {}),
    ("stokes", {"beam": 2, "stokes": "U"}), ("stokes", {"stokes": "V"}),
    ("stokes_fil", {"stokes": "Q"}), ("stokes_fil", {}),
]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kind,kw", LOAD_CASES)
def test_load_dynamic_spectrum(products, pkg, kind, kw):
    got = _same("load_dynamic_spectrum", products[pkg][kind], **kw)
    if got is not None:
        meta, x = got
        assert x.dtype == np.float64 and x.ndim == 2
        assert meta["f_lo_mhz"] < meta["f_hi_mhz"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kind,beams", [
    ("power", "all"), ("power", [1, 3, 30]), ("power", [40]),
    ("inco", "all"), ("inco", [0]), ("inco", [7]), ("fil8", [5]),
    ("stokes", [0, 2])])
def test_load_dynamic_spectra(products, pkg, kind, beams):
    got = _same("load_dynamic_spectra", products[pkg][kind], beams=beams)
    if got is not None:
        assert all(x.dtype == np.float32 for _, x in got[1])


def test_formats_agree_on_orientation(products):
    """The port's .fil and .dada products of one run render as the same
    image (the loader undoes the .fil channel flip)."""
    m_f, x_f = PQ.load_dynamic_spectrum(products["port"]["fil32"])
    m_d, x_d = PQ.load_dynamic_spectrum(products["port"]["power"], beam=3)
    np.testing.assert_allclose(x_f, x_d, rtol=1e-6)
    assert m_f["f_lo_mhz"] == pytest.approx(m_d["f_lo_mhz"])
    assert m_f["f_hi_mhz"] == pytest.approx(m_d["f_hi_mhz"])


# --------------------------- the two CLIs, byte for byte ------------------ #

def _cli_pair(argv, capsys, out=None):
    """The same argv through ``dsabf`` then ``dsabf-torch``: equal exit
    codes, stdout and stderr, and equal bytes at ``out`` when given.
    Returns the port's (rc, stdout, stderr)."""
    j = _main(jcli, list(argv), capsys)
    j_bytes = out.read_bytes() if out is not None and out.exists() else None
    if out is not None and out.exists():
        out.unlink()
    p = _main(pcli, list(argv), capsys)
    assert p == j
    if j_bytes is not None:
        assert out.read_bytes() == j_bytes
    return p


WATERFALL_CASES = [
    ("power", ["--beam", "1", "--rows", "8", "--cols", "16", "--pgm"]),
    ("power", ["--beam", "16", "--dm", "{dm}"]),
    ("power", ["--beam", "16", "--dm", "0", "--rows", "4", "--cols", "4"]),
    ("power", ["--clip", "5", "95", "--full", "--pgm"]),
    ("power", ["--clip", "60", "40"]),
    ("power", ["--clip", "-2", "99"]),
    ("power", ["--beam", "40"]),
    ("inco", ["--rows", "6", "--cols", "8"]),
    ("inco", ["--stokes", "Q"]),
    ("fil32", ["--full", "--pgm"]),
    ("fil8", ["--dm", "{dm}", "--rows", "12"]),
    ("stokes", ["--beam", "2", "--stokes", "V"]),
    ("stokes_fil", ["--stokes", "U", "--cols", "5"]),
    ("missing", []),
]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kind,args", WATERFALL_CASES)
def test_waterfall_cli_equal(products, tmp_path, capsys, pkg, kind, args):
    path = (tmp_path / "nope.fil" if kind == "missing"
            else products[pkg][kind])
    pgm = tmp_path / "wf.pgm"
    args = [a.replace("{dm}", str(products["dm"])) for a in args]
    if "--pgm" in args:
        args = [a for a in args if a != "--pgm"] + ["--out", str(pgm)]
    rc, out, _ = _cli_pair(["waterfall", str(path), *args], capsys,
                           pgm if "--out" in args else None)
    if kind == "missing" or "60" in args or "-2" in args or "40" in args \
            or (kind == "inco" and "Q" in args):
        assert rc == 1
    else:
        assert rc == 0 and out.startswith("# ")


FOLD_CASES = [
    ("power", ["--period", "{p8}", "--beam", "16", "--bins", "8"]),
    ("power", ["--period", "{p8}", "--beam", "16", "--dm", "{dm}",
               "--out"]),
    ("fil32", ["--period", "{p8}", "--bins", "4", "--clip", "2", "98"]),
    ("stokes", ["--period", "{p8}", "--stokes", "V", "--beam", "3"]),
    ("inco", ["--period", "{p8}"]),
    ("power", ["--period", "1e-12"]),
    ("power", ["--period", "10"]),
    ("power", ["--period", "{p8}", "--bins", "1"]),
]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("kind,args", FOLD_CASES)
def test_fold_cli_equal(products, tmp_path, capsys, pkg, kind, args):
    p8 = 8 * CFG2.sample_period_s * CFG2.navg_time
    pgm = tmp_path / "fold.pgm"
    args = [a.replace("{p8}", str(p8)).replace("{dm}", str(products["dm"]))
            for a in args]
    if "--out" in args:
        args.append(str(pgm))
    rc, out, _ = _cli_pair(["fold", str(products[pkg][kind]), *args],
                           capsys, pgm if "--out" in args else None)
    if rc == 0:
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["min_bin_occupancy"] > 0


def test_cmd_fold_end_to_end(tmp_path, capsys):
    """A synthetic-pulsar .fil: the same frame and JSON from both CLIs, a
    strong S/N at the injected phase, the PGM written, clean errors."""
    x = _pulsar(t=3000, f=16, phase=0.5, seed=7)
    hdr = {"fch1": 1500.0, "foff": -1.0, "nchans": 16, "nbits": 32,
           "nifs": 1, "tsamp": 1e-3, "ibeam": 0}
    p = tmp_path / "psr.fil"
    with open(p, "wb") as fh:
        fh.write(_encode_header_dict(hdr))
        fh.write(np.ascontiguousarray(x[:, ::-1]).astype("<f4").tobytes())
    out = tmp_path / "fold.pgm"
    rc, txt, _ = _cli_pair(["fold", str(p), "--period", "0.05", "--bins",
                            "20", "--out", str(out)], capsys, out)
    assert rc == 0 and "# profile(phase):" in txt
    summary = json.loads(txt.strip().splitlines()[-1])
    assert summary["snr"] > 10 and abs(summary["peak_phase"] - 0.5) < 0.1
    assert summary["n_periods"] == pytest.approx(60, abs=1)
    rc, _, err = _cli_pair(["fold", str(p), "--period", str(1e-3 / 3)],
                           capsys)
    assert rc == 1 and "error:" in err


# ------------------------------ the drills -------------------------------- #

def test_simulate_pulse_capture_roundtrip(tmp_path, capsys):
    """The port's simulate --pulse-dm -> run -> waterfall --dm: the
    dedispersed profile's bright char sits at the pulse start, and the
    JAX CLI renders the port's product to the same bytes."""
    dm = _pulse_dm(CFG2, 20)
    cap, out = tmp_path / "cap.dada", tmp_path / "out.dada"
    assert pcli.main(["simulate", "--config", "tiny", *NAVG2, "--pulse-dm",
                      str(dm), "--pulse-t0", "4", "--pulse-width", "4",
                      "--blocks", "1", "--distinct", "1", "--out-file",
                      str(cap)]) == 0
    assert pcli.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                      str(cap), "--output-file", str(out), "--device",
                      "cpu"]) == 0
    capsys.readouterr()
    rc, text, _ = _cli_pair(["waterfall", str(out), "--beam",
                             str(CFG2.n_beams // 2), "--dm", str(dm),
                             "--rows", "32", "--cols", "8"], capsys)
    assert rc == 0
    prof = [l for l in text.splitlines() if l.startswith("# profile")][0]
    ramp = prof.split(": ", 1)[1]
    assert ramp.index(max(ramp)) <= max(2, len(ramp) // 8)


def test_simulate_pulse_only_first_block(tmp_path, capsys):
    """The port's injected pulse is in block 0 only; --dm 0 still prints
    the profile line."""
    from dsabeamformer_tpu_torch.ingest.dada import read_dada_file
    from dsabeamformer_tpu_torch.ops.incoherent import incoherent_power_golden

    dm = _pulse_dm(CFG2, 10)
    cap, out = tmp_path / "cap.dada", tmp_path / "out.dada"
    assert pcli.main(["simulate", "--config", "tiny", *NAVG2, "--pulse-dm",
                      str(dm), "--pulse-width", "8", "--blocks", "4",
                      "--distinct", "2", "--out-file", str(cap)]) == 0
    _, _, off = read_dada_file(str(cap), CFG2)
    blocks = np.fromfile(cap, np.uint8, offset=off).reshape(
        4, *CFG2.wire_block_shape)
    p = [incoherent_power_golden(b, CFG2).max() for b in blocks]
    assert p[0] > 2 * max(p[1:]) and p[2] <= max(p[1:]) * 1.01
    assert pcli.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                      str(cap), "--output-file", str(out), "--device",
                      "cpu"]) == 0
    capsys.readouterr()
    rc, text, _ = _cli_pair(["waterfall", str(out), "--dm", "0", "--rows",
                             "4", "--cols", "4"], capsys)
    assert rc == 0 and "DM 0" in text and "# profile" in text


def test_dispersed_pulse_end_to_end_recovery(tmp_path):
    """The port's generator -> stream -> product -> dedisperse at the true
    DM: the pulse stands up in one output bin; per-channel arrivals follow
    the delay curve."""
    from dsabeamformer_tpu_torch.ingest.generator import (
        make_dispersed_pulse_block,
    )
    from dsabeamformer_tpu_torch.models.weights import make_weights
    from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
    from dsabeamformer_tpu_torch.pipeline import (
        FileSink,
        SyntheticSource,
        run_stream,
    )

    dm = _pulse_dm(CFG2, 20)
    wire = make_dispersed_pulse_block(CFG2, dm, t0_sample=4,
                                      width_samples=4, amplitude=7.0,
                                      noise_rms=0.5, seed=3)
    qw = prepare_weights(CFG2, make_weights(CFG2, device="cpu"))
    sink = FileSink(tmp_path / "out.dada", CFG2)
    run_stream(CFG2, qw, SyntheticSource(CFG2, [wire], 1), sink)
    sink.close()
    meta, x = PQ.load_dynamic_spectrum(tmp_path / "out.dada",
                                       beam=CFG2.n_beams // 2)
    _assert_equal(PQ.dedisperse(x, meta, dm), JQ.dedisperse(x, meta, dm))
    d = PQ.dedisperse(x, meta, dm)
    prof_d, prof_0 = d.mean(axis=1), x.mean(axis=1)
    snr_d = (prof_d.max() - np.median(prof_d)) / (np.median(prof_d) + 1e-30)
    snr_0 = (prof_0.max() - np.median(prof_0)) / (np.median(prof_0) + 1e-30)
    assert snr_d > 2 * snr_0
    assert abs(int(np.argmax(prof_d)) - 2) <= 2
    f_mhz = CFG2.freqs_hz() / 1e6
    want = (4 + np.rint(DM_CONST_S * dm * (f_mhz**-2 - f_mhz.max()**-2)
                        / CFG2.sample_period_s)) // CFG2.navg_time
    assert np.abs(x.argmax(axis=0) - want).max() <= 1


def test_pulsar_fold_drill(tmp_path, capsys):
    """The port's simulate --pulse-period -> run -> fold: the train stands
    up at its phase, a wrong period collapses it, and the JAX CLI folds the
    port's product to the same bytes."""
    period = 16
    cap, out = tmp_path / "psr.dada", tmp_path / "out.dada"
    assert pcli.main(["simulate", "--config", "tiny", *NAVG2,
                      "--pulse-period", str(period), "--pulse-width", "2",
                      "--pulse-t0", "3", "--blocks", "8", "--out-file",
                      str(cap)]) == 0
    assert pcli.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                      str(cap), "--output-file", str(out), "--device",
                      "cpu"]) == 0
    capsys.readouterr()
    period_s = period * CFG2.sample_period_s
    beam = str(CFG2.n_beams // 2)
    rc, text, _ = _cli_pair(["fold", str(out), "--period", str(period_s),
                             "--beam", beam, "--bins", "8"], capsys)
    assert rc == 0
    summary = json.loads(text.strip().splitlines()[-1])
    assert summary["snr"] > 10
    assert summary["n_periods"] == pytest.approx(32, abs=0.1)
    assert abs(summary["peak_phase"] - 3 / 16) < 0.2
    rc, text, _ = _cli_pair(["fold", str(out), "--period",
                             str(period_s * 1.29), "--beam", beam,
                             "--bins", "8"], capsys)
    s2 = json.loads(text.strip().splitlines()[-1])
    assert rc == 0 and s2["snr"] < summary["snr"] / 2
    rc, _, _ = _cli_pair(["simulate", "--config", "tiny", "--pulse-period",
                          "4", "--pulse-width", "8", "--out-file",
                          str(tmp_path / "x.dada")], capsys)
    assert rc == 2


@pytest.mark.parametrize("args", [
    ["--pulse-dm", "{dm}", "--pulse-t0", "8", "--pulse-width", "6",
     "--distinct", "3"],
    ["--distinct", "2"],
    ["--source-angle", "3", "--pulse-dm", "{dm}", "--distinct", "2"],
    ["--pulse-period", "16", "--pulse-width", "2", "--pulse-t0", "3"],
])
def test_simulate_capture_equals_jax(tmp_path, capsys, args):
    """The drills' captures (the pulse block and the noise pool made on two
    threads in the port) are the JAX package's byte for byte."""
    args = [a.replace("{dm}", str(_pulse_dm(CFG2, 16))) for a in args]
    paths = []
    for which in (jcli, pcli):
        paths.append(tmp_path / f"{which.__name__}.dada")
        assert which.main(["simulate", "--config", "tiny", *NAVG2,
                           "--blocks", "5", *args, "--out-file",
                           str(paths[-1])]) == 0
    assert paths[0].read_bytes() == paths[1].read_bytes()
