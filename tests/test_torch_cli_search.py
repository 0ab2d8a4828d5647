"""``dsabf-torch search`` (offline: product files, ``--stream``) and
``waterfall --cand`` against the JAX package's ``dsabf`` on the CPU: the
same argv through both CLIs (the port's with ``--device cpu``) gives the
same exit code, the same error, the same candidate rows one for one (S/N
within 1e-5 relative + 0.01, the bar of ``tests/test_torch_cli.py``; the
``direct`` and ``subband`` banks are bit-equal) and the same ``.cand``
header fields.  The counterparts of ``tests/test_dedisperse.py``'s CLI
search tests; the ring consumer is in
``tests/test_torch_cli_search_ring.py``."""

import os

import numpy as np
import pytest

from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import DM_CONST_S, TINY
from dsabeamformer_tpu_torch.ingest.sigproc import _encode_header_dict
from dsabeamformer_tpu_torch.ops.dedisperse import read_candidates
from test_torch_cli import _main
from test_torch_dedisperse import TSAMP, _pulse_spectrogram

F_HI = 1530.0
F_LO = 1280.0
CFG2 = TINY.replace(navg_time=2)
NAVG2 = ["--set", "navg_time=2"]
SNR_RTOL, SNR_ATOL = 1e-5, 0.01


def _write_fil(path, x_ascending, tsamp, ibeam=0):
    """A 32-bit SIGPROC file, channels stored descending."""
    nf = x_ascending.shape[1]
    hdr = {"fch1": F_HI, "foff": -(F_HI - F_LO) / (nf - 1), "nchans": nf,
           "nbits": 32, "nifs": 1, "tsamp": tsamp, "ibeam": ibeam}
    with open(path, "wb") as fh:
        fh.write(_encode_header_dict(hdr))
        fh.write(np.ascontiguousarray(x_ascending[:, ::-1],
                                      np.float32).tobytes())


def _rows(out):
    return [line.split() for line in out.splitlines()
            if line.strip() and not line.startswith("#")]


def _same_rows(rp, rj):
    assert len(rp) == len(rj), (rp, rj)
    for p, j in zip(rp, rj):
        assert p[1:] == j[1:]
        if p[0] != j[0]:
            assert abs(float(p[0]) - float(j[0])) <= SNR_RTOL * abs(
                float(j[0])) + SNR_ATOL


def _errors(err, port):
    lines = [l for l in err.splitlines() if l.startswith("error:")]
    return [l.replace("dsabf-torch", "dsabf") for l in lines] if port \
        else lines


def _search(argv, capsys, cand=None):
    """The same ``search`` argv through both CLIs (``--cand`` to a file of
    each's own when ``cand`` is given): equal exit codes and errors,
    candidate rows one for one, and equal ``.cand`` header fields.
    Returns the port's (rc, stdout, stderr)."""
    res, metas = [], []
    for which in (jcli, pcli):
        extra = ["--device", "cpu"] if which is pcli else []
        path = None
        if cand is not None:
            path = f"{cand}.{which.__name__.split('.')[0]}"
            extra += ["--cand", path]
        res.append(_main(which, ["search", *argv, *extra], capsys))
        if path is not None and os.path.exists(path):
            metas.append(read_candidates(path))
    (rj, oj, ej), (rp, op, ep) = res
    assert rp == rj, (ej, ep)
    assert _errors(ep, True) == _errors(ej, False)
    _same_rows(_rows(op), _rows(oj))
    assert [l for l in op.splitlines() if l.startswith("# ...")] \
        == [l for l in oj.splitlines() if l.startswith("# ...")]
    if metas:
        (mj, cj), (mp, cp) = metas
        assert mp == mj
        _same_rows([c.row().split() for c in cp],
                   [c.row().split() for c in cj])
    return rp, op, ep


def test_cli_search_fil_end_to_end(tmp_path, capsys):
    """A .fil with an injected dispersed pulse: the table, the candidate
    file, the DM recovered, the same from both."""
    dm_true = 90.0
    x, _ = _pulse_spectrogram(2048, 64, dm_true, 700, 4, amp=1.0, seed=11)
    fil = tmp_path / "beam.fil"
    _write_fil(fil, x, TSAMP)
    cand = tmp_path / "beam.cand"
    rc, out, err = _search([str(fil), "--dm-max", "300", "--threshold",
                            "7"], capsys, cand=cand)
    assert rc == 0 and "x realtime" in err
    best = _rows(out)[0]
    assert float(best[0]) > 10.0 and abs(float(best[5]) - dm_true) < 10.0
    body = open(f"{cand}.dsabeamformer_tpu_torch").read()
    assert "# threshold = 7.0" in body and "# n_dm_trials" in body


def test_cli_search_multibeam_fil_coincidence(tmp_path, capsys):
    """Eight per-beam .fil files: the broadband spike in every beam is
    rejected as RFI, the pulse in two beams is kept with its beam; with
    --no-coincidence the spike comes back."""
    t0, paths = 700, []
    for b in range(8):
        x, _ = _pulse_spectrogram(2048, 64, 90.0, t0, 4,
                                  amp=1.0 if b in (3, 4) else 0.0,
                                  seed=40 + b)
        x[300:302, :] += 3.0
        p = tmp_path / f"beam_{b:04d}.fil"
        _write_fil(p, x, TSAMP, ibeam=b)
        paths.append(str(p))
    base = [*paths, "--dm-max", "300", "--threshold", "7"]
    rc, out, err = _search(base, capsys, cand=tmp_path / "multi.cand")
    assert rc == 0 and "rfi-coincidence" in err
    rows = _rows(out)
    assert rows and {int(r[9]) for r in rows} <= {3, 4}
    assert all(abs(int(r[1]) - t0) < 32 for r in rows)
    rc, out, _ = _search(base + ["--no-coincidence", "--limit", "200"],
                         capsys)
    assert any(abs(int(r[1]) - 300) < 16 for r in _rows(out))


@pytest.fixture(scope="module")
def drill_product(tmp_path_factory):
    """The injected-FRB drill's product, from the port's run."""
    d = tmp_path_factory.mktemp("drill")
    f = CFG2.freqs_hz() / 1e6
    tsamp_out = CFG2.sample_period_s * CFG2.navg_time
    dm = 16 * tsamp_out / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2))
    cap, out = d / "cap.dada", d / "out.dada"
    assert pcli.main(["simulate", "--config", "tiny", *NAVG2, "--pulse-dm",
                      str(dm), "--pulse-t0", "8", "--pulse-width", "6",
                      "--blocks", "6", "--distinct", "2", "--out-file",
                      str(cap)]) == 0
    assert pcli.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                      str(cap), "--output-file", str(out),
                      "--incoherent-file", str(d / "inco.dada"),
                      "--utc-start", "2026-08-18-04:00:00", "--tstart-mjd",
                      "61270.1666", "--device", "cpu"]) == 0
    stokes = d / "stokes.dada"
    assert pcli.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                      str(cap), "--output-file", str(stokes), "--products",
                      "stokes", "--device", "cpu"]) == 0
    return {"dm": dm, "power": out, "inco": d / "inco.dada",
            "stokes": stokes}


def _drill_flags(dm):
    return ["--no-coincidence", "--dm-max", str(2 * dm), "--threshold", "8",
            "--widths", "1", "2", "4"]


@pytest.mark.parametrize("extra", [[], ["--zerodm"], ["--zap", "1,5"],
                                   ["--method", "subband"],
                                   ["--method", "conv"],
                                   ["--dm-step", "{step}"],
                                   ["--limit", "2", "--topk", "2"]])
def test_cli_search_dada_all_beams(drill_product, tmp_path, capsys, extra):
    """--beam all on a DADA product searches every beam from one read; the
    drill pulse's strongest candidate sits in the pointed beam; the epoch
    rides into the .cand file; equal to JAX under each option."""
    dm = drill_product["dm"]
    extra = [e.replace("{step}", str(dm / 8)) for e in extra]
    rc, out, err = _search([str(drill_product["power"]), "--beam", "all",
                            *_drill_flags(dm), *extra], capsys,
                           cand=tmp_path / "e.cand")
    assert rc == 0 and f"{CFG2.n_beams} beam(s)" in err
    assert ("# ... " in out) == ("--limit" in extra)
    rows = _rows(out)
    assert rows and int(rows[0][9]) in (CFG2.n_beams // 2 - 1,
                                        CFG2.n_beams // 2)
    meta, _ = read_candidates(f"{tmp_path / 'e.cand'}."
                              f"dsabeamformer_tpu_torch")
    assert meta["utc_start"] == "2026-08-18-04:00:00"
    assert float(meta["tstart_mjd"]) == pytest.approx(61270.1666)


def test_cli_search_stokes_and_beam_sets(drill_product, capsys):
    dm = drill_product["dm"]
    for argv in ([str(drill_product["stokes"]), "--beam", "10-20",
                  "--stokes", "Q"],
                 [str(drill_product["stokes"]), "--beam", "16"],
                 [str(drill_product["power"]), "--beam", "15,16",
                  "--stokes", "V"]):
        _search(argv + _drill_flags(dm), capsys)


def test_cli_search_rejects_absurd_dm_grid(tmp_path, capsys):
    x = np.random.default_rng(0).normal(size=(64, 16)).astype(np.float32)
    p = tmp_path / "fast.fil"
    _write_fil(p, x, tsamp=1e-7)
    rc, _, err = _search([str(p), "--dm-max", "1000"], capsys)
    assert rc == 1 and "trials" in err and "--dm-step" in err


def test_cli_search_rejects_headerless_product(tmp_path, capsys):
    p = tmp_path / "x.fil"
    p.write_bytes(b"garbage")
    rc, _, err = _search([str(p)], capsys)
    assert rc == 1 and "error:" in err


def test_cli_search_rejects_bad_coincidence_frac(tmp_path, capsys):
    p = tmp_path / "b.fil"
    _write_fil(p, np.zeros((64, 8), np.float32), TSAMP)
    rc, _, err = _search([str(p), str(p), "--dm-max", "10",
                          "--coincidence-frac", "1.5"], capsys)
    assert rc == 1 and "coincidence-frac" in err


@pytest.mark.parametrize("argv", [
    ["{a}", "{a}", "--dm-max", "10"],          # duplicate beam labels
    ["{a}", "{c}", "--dm-max", "10"],          # band/cadence differ
    ["{a}", "--beam", "1-x", "--dm-max", "10"],
    ["--dm-max", "10"],                        # neither files nor --key
    ["{a}", "--key", "x", "--dm-max", "10"],   # both
    ["{a}", "--zap", "a", "--dm-max", "10"],
])
def test_cli_search_argument_errors(tmp_path, capsys, argv):
    a, c = tmp_path / "a.fil", tmp_path / "c.fil"
    _write_fil(a, np.zeros((64, 8), np.float32), TSAMP)
    _write_fil(c, np.zeros((64, 8), np.float32), 2 * TSAMP, ibeam=1)
    argv = [s.replace("{a}", str(a)).replace("{c}", str(c)) for s in argv]
    rc, _, err = _search(argv, capsys)
    assert rc == 1 and "error:" in err


def test_cli_search_stream_matches_whole(drill_product, capsys):
    """--stream (block-fed monitor) finds what the whole-load search finds
    on the same DADA product, in both packages; the bad cases fail alike."""
    dm = drill_product["dm"]
    base = [str(drill_product["power"]), "--beam", "all", *_drill_flags(dm)]
    _, whole, _ = _search(base, capsys)
    rc, streamed, _ = _search(base + ["--stream"], capsys)
    assert rc == 0 and _rows(whole) and _rows(streamed) == _rows(whole)
    _search(base + ["--stream", "--blocks", "3"], capsys)
    _search([str(drill_product["inco"]), "--stream", "--beam", "incoherent",
             *_drill_flags(dm)], capsys)
    rc, _, _ = _search([str(drill_product["power"]),
                        str(drill_product["power"]), "--stream",
                        "--dm-max", "1"], capsys)
    assert rc == 1
    rc, _, err = _search([str(drill_product["power"]), "--stream", "--beam",
                          "99", "--dm-max", str(2 * dm)], capsys)
    assert rc == 1 and "out of range" in err
    rc, _, err = _search([str(drill_product["power"]), "--stream",
                          "--stokes", "Q", "--dm-max", str(2 * dm)], capsys)
    assert rc == 1 and "power-only" in err


def test_search_review_fixes(drill_product, tmp_path, capsys):
    """(a) an explicit --beam on an incoherent product errors instead of
    searching the sum; (b) a single-beam monitor labels its candidates;
    (c) a headered but empty ring ends cleanly at --max-idle."""
    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.ops.dedisperse import (
        SearchMonitor,
        dm_trial_grid,
    )
    from dsabeamformer_tpu_torch.utils.quicklook import load_dynamic_spectra

    inco = drill_product["inco"]
    with pytest.raises(ValueError, match="no beam axis"):
        load_dynamic_spectra(inco, beams=[7])
    rc, _, err = _search([str(inco), "--beam", "7", "--dm-max", "0.001"],
                         capsys)
    assert rc == 1 and "no beam axis" in err

    x, freqs = _pulse_spectrogram(2048, 64, 90.0, 700, 4, amp=1.0, seed=21)
    dms = dm_trial_grid(F_LO, F_HI, TSAMP, dm_max=300.0, tol=1.25)
    mon = SearchMonitor(freqs, TSAMP, dms, beam=1, threshold=7.5,
                        chunk_t=512, device="cpu")
    blk = np.zeros((64, 2048, 3), np.float32)
    blk[:, :, 1] = x.T
    mon.observe(0, blk)
    mon.flush()
    assert mon.candidates and all(c.beam == 1 for c in mon.candidates)

    f_out, t_out, _ = TINY.out_block_shape
    hdr = dada.encode_header(TINY, PAYLOAD="INCOHERENT_POWER",
                             OUT_DTYPE="float32", OUT_NCHAN=f_out,
                             OUT_NTIME=t_out)
    for which in (jcli, pcli):
        key = f"ttidle{os.getpid()}{which is pcli:d}"
        with RingBuffer(key, create=True, nbufs=2,
                        bufsz=f_out * t_out * 4) as r:
            r.write_header(hdr)
            extra = ["--device", "cpu"] if which is pcli else []
            rc, _, err = _main(which, ["search", "--key", key, "--dm-max",
                                       "0.001", "--timeout", "0.2",
                                       "--max-idle", "0.5", *extra], capsys)
            r.destroy()
        assert rc == 0, err
        assert "waiting for data" in err and "--max-idle" in err


def test_cli_waterfall_cand_vetting(tmp_path, capsys):
    """``waterfall --cand f --idx 0`` inherits the row's DM and windows the
    frame on the detection: the port's search's .cand through both
    waterfalls, byte for byte, and the JAX search's through the port's."""
    dm_true, t0 = 90.0, 1500
    x, _ = _pulse_spectrogram(4096, 64, dm_true, t0, 4, amp=1.2, seed=3)
    fil = tmp_path / "b.fil"
    _write_fil(fil, x, TSAMP, ibeam=5)
    cand = tmp_path / "b.cand"
    rc, _, _ = _search([str(fil), "--dm-max", "300", "--threshold", "7"],
                       capsys, cand=cand)
    assert rc == 0
    outs = []
    for which, c in ((jcli, "dsabeamformer_tpu_torch"),
                     (pcli, "dsabeamformer_tpu_torch"),
                     (pcli, "dsabeamformer_tpu")):
        outs.append(_main(which, ["waterfall", str(fil), "--cand",
                                  f"{cand}.{c}"], capsys))
    (rj, oj, ej), (rp, op, ep), (rx, ox, _) = outs
    assert rj == rp == rx == 0 and op == oj and ep == ej and ox == op
    assert "# candidate 0:" in ep and "t_samp 1500" in ep
    assert abs(float(ep.split("DM ")[1].split()[0]) - dm_true) < 5
    legend = [l for l in op.splitlines() if l.startswith("#")][0]
    assert int(legend.split(" samples")[0].split()[-1]) < 4096
    assert "profile(t)" in op
    for idx in ("999", "-1"):
        rj, _, ej = _main(jcli, ["waterfall", str(fil), "--cand",
                                 f"{cand}.dsabeamformer_tpu", "--idx", idx],
                          capsys)
        rp, _, ep = _main(pcli, ["waterfall", str(fil), "--cand",
                                 f"{cand}.dsabeamformer_tpu", "--idx", idx],
                          capsys)
        assert rj == rp == 1 and ep == ej
    bad = tmp_path / "bad.cand"
    bad.write_text("1 2 3\n")
    short = tmp_path / "short.fil"
    _write_fil(short, x[:1000], TSAMP, ibeam=5)
    for argv in (["waterfall", str(fil), "--cand", str(bad)],
                 ["waterfall", str(short), "--cand",
                  f"{cand}.dsabeamformer_tpu"]):
        rj, oj, ej = _main(jcli, argv, capsys)
        rp, op, ep = _main(pcli, argv, capsys)
        assert rj == rp == 1 and (op, ep) == (oj, ej)
