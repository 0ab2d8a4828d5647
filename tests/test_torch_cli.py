"""The port's CLI (``dsabf-torch``, ``dsabeamformer_tpu_torch/cli.py``)
against the JAX package's ``dsabf`` on the CPU at the ``tiny`` preset: the
same argv through both ``main``s (the port's with ``--device cpu`` where it
takes one) gives the same JSON records apart from wall times and rates, the
same exit codes and error cases, and products within the bars the port's
other tests hold for the same product (``.dada`` / raw power: relative
power error <= 1e-3, as tests/test_torch_pipeline.py; ``.fil`` headers
equal, data within tests/test_torch_sigproc.py's bars; the incoherent
product as tests/test_torch_incoherent.py; candidates one for one, as
tests/test_torch_pipeline_search.py)."""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu.config import DM_CONST_S
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import TINY
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.ingest.sigproc import read_filterbank
from dsabeamformer_tpu_torch.ops.incoherent import incoherent_power_golden
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

#: The stream record's keys that carry no timing (wall times, rates and the
#: tensor-core accounting are each package's own).
STATIC_KEYS = ("config", "blocks", "bytes", "dropped", "skipped")
#: Power products, port against JAX (tests/test_torch_pipeline.py's bar).
POWER_RTOL = 1e-3
#: The incoherent product (tests/test_torch_incoherent.py: exact integers).
INCO_RTOL = 0.0


def _main(which, argv, capsys):
    """Run one CLI in-process: (rc, stdout, stderr)."""
    capsys.readouterr()
    rc = which.main(argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


def _both(argv, capsys, device=True):
    """The same argv through ``dsabf`` and ``dsabf-torch`` (``--device cpu``
    added to the port's when ``device``): ``((rc, out, err) JAX, (...)
    port)``."""
    j = _main(jcli, list(argv), capsys)
    p = _main(pcli, list(argv) + (["--device", "cpu"] if device else []),
              capsys)
    return j, p


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _static(rec):
    return {k: rec[k] for k in STATIC_KEYS}


def _capture(path, cfg, seeds):
    """A raw capture file of noise blocks."""
    with open(path, "wb") as f:
        for s in seeds:
            f.write(make_noise_block(cfg, rms=2.0, seed=s).tobytes())
    return str(path)


def _powers_close(a, b):
    a, b = (np.fromfile(p, np.float32) for p in (a, b))
    assert a.shape == b.shape and a.size
    assert relative_power_error(b, a) <= POWER_RTOL


# ------------------------------ tests/test_cli.py ------------------------- #

def test_selftest(capsys):
    (rj, oj, _), (rp, op, _) = _both(["selftest"], capsys)
    assert rj == rp == 0
    j, p = json.loads(oj), json.loads(op)
    assert p["ok"] and p["backend"] == "cpu"
    for k in ("beam_expected", "beam_peak", "bar", "ok"):
        assert p[k] == j[k]
    assert p["rel_power_error"] <= p["bar"]


def test_weights_roundtrip(tmp_path, capsys):
    """The same table from both (the port's made on ``--device cpu``),
    byte for byte, loadable by either package."""
    from dsabeamformer_tpu_torch.ops.quantize import load_quant_weights

    pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    (rj, oj, _) = _main(jcli, ["weights", "--config", "tiny", "--out", pj],
                        capsys)
    (rp, op, _) = _main(pcli, ["weights", "--config", "tiny", "--out", pp,
                               "--device", "cpu"], capsys)
    assert rj == rp == 0
    mj, mp = json.loads(oj), json.loads(op)
    assert mp["terms"] == 2 and {**mj, "out": pp} == mp
    qj, qp = (load_quant_weights(p, device="cpu") for p in (pj, pp))
    for a, b in zip(qj.terms, qp.terms):
        assert torch.equal(a, b)
    assert torch.equal(qj.scales, qp.scales)


def test_run_from_file_with_saved_weights(tmp_path, capsys):
    wpath = str(tmp_path / "w.npz")
    assert jcli.main(["weights", "--config", "tiny", "--out", wpath]) == 0
    inpath = _capture(tmp_path / "in.raw", TINY, range(2))
    outs, stats = [], []
    for which in (jcli, pcli):
        out = str(tmp_path / f"out-{which.__name__}.raw")
        st = str(tmp_path / f"stats-{which.__name__}.jsonl")
        argv = ["run", "--config", "tiny", "--input-file", inpath,
                "--weights", wpath, "--output-file", out,
                "--stats-file", st]
        if which is pcli:
            argv += ["--device", "cpu"]
        rc, o, _ = _main(which, argv, capsys)
        assert rc == 0
        outs.append(out)
        stats.append((_last_json(o), [json.loads(line) for line in open(st)]))
    (sj, lj), (sp, lp) = stats
    assert _static(sj) == _static(sp)
    assert sp["blocks"] == 2 and sp["dropped"] == 0
    assert [(r["block"], r["seq"], r["bytes"]) for r in lj] \
        == [(r["block"], r["seq"], r["bytes"]) for r in lp]
    _powers_close(*outs)


def test_interrupt_flushes_product_file(tmp_path, capsys, monkeypatch):
    """Ctrl-C mid-run: exit 130 with the processed blocks' record, every
    product block on disk and parsed, the stats handle flushed."""
    from dsabeamformer_tpu_torch import pipeline

    inpath = _capture(tmp_path / "in.raw", TINY, range(3))
    outpath = tmp_path / "out.dada"
    statspath = tmp_path / "stats.jsonl"
    orig_run = pipeline.StreamingBeamformer.run

    def run_then_interrupt(self, max_blocks=None):
        orig_run(self, max_blocks=2)
        raise KeyboardInterrupt

    monkeypatch.setattr(pipeline.StreamingBeamformer, "run",
                        run_then_interrupt)
    rc, out, _ = _main(pcli, [
        "run", "--config", "tiny", "--input-file", inpath,
        "--output-file", str(outpath), "--stats-file", str(statspath),
        "--device", "cpu"], capsys)
    assert rc == 130
    assert _last_json(out)["blocks"] == 2
    h, powers = dada.read_product_file(outpath)
    assert h["PAYLOAD"] == "BEAM_POWERS"
    assert powers.shape[0] == 2
    assert np.isfinite(np.asarray(powers)).all()
    assert len([json.loads(line) for line in open(statspath)]) == 2


def test_config_override(tmp_path, capsys):
    (rj, oj, _), (rp, op, _) = (
        _main(which, ["weights", "--config", "tiny", "--set", "n_beams=64",
                      "--out", str(tmp_path / f"{k}.npz")] + extra, capsys)
        for k, which, extra in (("j", jcli, []),
                                ("p", pcli, ["--device", "cpu"])))
    assert rj == rp == 0
    assert json.loads(op)["shape"] == json.loads(oj)["shape"]
    assert json.loads(op)["shape"][-1] == 128  # 2*n_beams


def test_bad_config_key_fails(tmp_path):
    for which in (jcli, pcli):
        with pytest.raises(AttributeError):
            which.main(["weights", "--config", "tiny", "--set", "nope=1",
                        "--out", str(tmp_path / "x.npz")])


@pytest.mark.parametrize("current,token", [
    (True, "false"), (True, "0"), (False, "TRUE"), (False, "on"),
    (3, "7"), (1.5, "2.25")])
def test_set_bool_coercion_tokens(current, token):
    assert pcli._coerce_field(current, token) \
        == jcli._coerce_field(current, token)
    assert type(pcli._coerce_field(current, token)) \
        is type(jcli._coerce_field(current, token))


def test_set_bool_coercion_bad_token():
    for which in (jcli, pcli):
        with pytest.raises(ValueError, match="bool"):
            which._coerce_field(True, "nope")


def test_run_device_cpu_and_missing_card(tmp_path, capsys, monkeypatch):
    """In place of the JAX package's device-pinning test: ``--device cpu``
    runs on the host; ``--device 0``, or no ``--device``, with no usable
    card exits 2 with ``resolve_device``'s message, never on the CPU."""
    from dsabeamformer_tpu_torch.utils.device import resolve_device

    inpath = _capture(tmp_path / "in.raw", TINY, range(2))
    rc, out, _ = _main(pcli, ["run", "--config", "tiny", "--input-file",
                              inpath, "--device", "cpu", "--blocks", "2"],
                       capsys)
    assert rc == 0 and _last_json(out)["blocks"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device("cuda:0")
    for extra in (["--device", "0"], ["--device", "cuda:0"], []):
        out_file = tmp_path / "never.raw"
        rc, out, err = _main(pcli, ["run", "--config", "tiny",
                                    "--input-file", inpath, "--output-file",
                                    str(out_file)] + extra, capsys)
        assert rc == 2 and out == ""
        assert str(want.value) in err
        assert not out_file.exists()
        rc, out, err = _main(pcli, ["selftest"] + extra, capsys)
        assert rc == 2 and str(want.value) in err
    rc, _, err = _main(pcli, ["run", "--config", "tiny", "--input-file",
                              inpath, "--device", "gpu"], capsys)
    assert rc == 2 and "card index" in err


#: tiny with the DSA-110 sharding structure: 16 channels over 8 slots
#: (tests/test_cli.py's ``--mesh`` runs).
MESH_SET = ["--set", "n_chan_total=16", "--set", "n_chan=16"]


def test_run_mesh_streams_sharded(tmp_path, capsys):
    """``run --mesh 8 --device cpu`` (eight slots on the host) against the
    JAX package's ``run --mesh 8`` (its eight virtual devices): the same
    record, the products within the power bar and golden-accurate, and
    byte for byte the port's own run without ``--mesh``."""
    from dsabeamformer_tpu_torch.models.weights import weights_numpy_golden
    from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref

    cfg = TINY.replace(n_chan=16, n_chan_total=16)
    inpath = _capture(tmp_path / "in.raw", cfg, range(3))
    base = ["run", "--config", "tiny", *MESH_SET, "--input-file", inpath]
    runs = {}
    for name, which, extra in (
            ("jax", jcli, ["--mesh", "8"]),
            ("mesh", pcli, ["--mesh", "8", "--device", "cpu"]),
            ("single", pcli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.raw")
        rc, o, err = _main(which, base + extra + ["--output-file", out],
                           capsys)
        assert rc == 0, err
        if name != "single":
            assert "[dsabf] mesh: 8 device(s) x 2 channels each" in err
        runs[name] = out, _last_json(o)
    assert _static(runs["mesh"][1]) == _static(runs["jax"][1])
    assert runs["mesh"][1]["blocks"] == 3 and runs["mesh"][1]["dropped"] == 0
    _powers_close(runs["jax"][0], runs["mesh"][0])
    mesh, single = (Path(runs[k][0]).read_bytes() for k in ("mesh",
                                                             "single"))
    assert mesh == single
    powers = np.fromfile(runs["mesh"][0], np.float32).reshape(
        (3,) + cfg.out_block_shape)
    for i in range(3):
        ref = beamform_block_ref(
            weights_numpy_golden(cfg),
            make_noise_block(cfg, rms=2.0, seed=i), cfg.input_layout,
            cfg.navg_time, cfg.navg_freq)
        assert relative_power_error(powers[i], ref) <= POWER_RTOL


def test_run_mesh_with_monitors(tmp_path, capsys):
    """``--mesh`` with the fused monitors (``--rfi-auto``'s SK accumulators
    and ``--incoherent-file`` ride the sharded kernel): the incoherent
    product equal to JAX's, the same RFI log lines."""
    cfg = TINY.replace(n_chan=16, n_chan_total=16)
    inpath = _capture(tmp_path / "in.raw", cfg, range(2))
    got = {}
    for name, which, extra in (("jax", jcli, []),
                               ("port", pcli, ["--device", "cpu"])):
        inco = tmp_path / f"{name}.dada"
        rc, o, err = _main(which, [
            "run", "--config", "tiny", *MESH_SET, "--mesh", "8",
            "--input-file", inpath, "--incoherent-file", str(inco),
            "--rfi-auto", "--rfi-interval", "2"] + extra, capsys)
        assert rc == 0, err
        assert _last_json(o)["blocks"] == 2
        got[name] = (dada.read_product_file(inco),
                     [ln for ln in err.splitlines() if "rfi" in ln])
    (hp, ip), rfi_p = got["port"]
    (hj, ij), rfi_j = got["jax"]
    assert hp["PAYLOAD"] == "INCOHERENT_POWER"
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(ij))
    np.testing.assert_allclose(
        np.asarray(ip)[0],
        incoherent_power_golden(make_noise_block(cfg, rms=2.0, seed=0), cfg),
        rtol=1e-6)
    assert rfi_p == rfi_j


def test_run_mesh_must_divide_channels(tmp_path, capsys):
    """A mesh that does not divide the channels exits 2 before anything is
    made, with the JAX package's message."""
    inpath = _capture(tmp_path / "in.raw", TINY, range(1))
    errs = []
    for which, extra in ((jcli, []), (pcli, ["--device", "cpu"])):
        rc, out, err = _main(which, ["run", "--config", "tiny", "--mesh",
                                     "3", "--input-file", inpath] + extra,
                             capsys)
        assert rc == 2 and out == ""
        errs.append(err.strip().splitlines()[-1])
    assert errs[1] == errs[0] \
        == "error: --mesh 3: n_chan=8 not divisible by mesh size 3"


def test_run_mesh_without_device_needs_the_cards(tmp_path, capsys,
                                                 monkeypatch):
    """Without ``--device`` the mesh takes N distinct cards: on a host
    with fewer it exits 2 with ``make_mesh``'s message, and nothing runs
    on the CPU."""
    inpath = _capture(tmp_path / "in.raw", TINY, range(1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out_file = tmp_path / "never.raw"
    rc, out, err = _main(pcli, ["run", "--config", "tiny", "--mesh", "2",
                                "--input-file", inpath, "--output-file",
                                str(out_file)], capsys)
    assert rc == 2 and out == "" and not out_file.exists()
    assert "error: --mesh 2: requested 2 devices, have 1" in err


def test_ring_monitor(capsys):
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    key = f"tclimon{os.getpid()}"
    with RingBuffer(key, create=True, nbufs=4, bufsz=64) as ring:
        ring.write_header("HDR 1.0\n")
        ring.write_block(np.zeros(64, np.uint8))
        ring.write_block(np.ones(64, np.uint8))
        (rj, oj, _), (rp, op, _) = _both(["ring", "--key", key], capsys,
                                         device=False)
        assert rj == rp == 0
        rec = _last_json(op)
        assert rec == _last_json(oj)
        assert rec["written"] == 2 and rec["backlog"] == 2
        assert rec["nbufs"] == 4 and rec["bufsz"] == 64
        assert rec["dropped"] == 0 and rec["eod"] is False


def test_subband_flag(capsys):
    """--subband I/N: the same geometry and sizing keys as the JAX
    package's info, and the same refusals."""
    from dsabeamformer_tpu_torch.config import DSA10

    argv = ["info", "--config", "dsa10", "--subband", "3/8"]
    (rj, oj, _), (rp, op, _) = _both(argv, capsys, device=False)
    assert rj == rp == 0
    j, p = json.loads(oj), json.loads(op)
    sub = DSA10.subband(3 * 256, 256)
    assert p["wire_block_bytes"] == sub.wire_block_bytes
    assert p["realtime_gb_per_s"] == round(sub.realtime_bytes_per_s / 1e9, 3)
    for k in ("version", "config", "wire_block_bytes", "block_duration_s",
              "realtime_gb_per_s", "out_block_shape", "weight_mode",
              "weight_bytes", "hbm_wire_bytes_depth2",
              "host_staging_bytes_depth2"):
        assert p[k] == j[k], k
    assert p["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert p["n_devices"] == len(p["devices"])
    for which in (jcli, pcli):
        with pytest.raises(SystemExit, match="I/N"):
            which.main(["info", "--config", "dsa10", "--subband", "3"])
        with pytest.raises(SystemExit, match="divide"):
            which.main(["info", "--config", "dsa10", "--subband", "0/7"])


def test_subband_end_to_end(tmp_path, capsys):
    """A subband capture from the port's simulate round-trips through both
    runs (the DADA header carries the subband geometry), and --subband
    with a DADA capture is refused by both."""
    cap = str(tmp_path / "cap.dada")
    rc, out, _ = _main(pcli, ["simulate", "--config", "tiny", "--subband",
                              "1/2", "--blocks", "2", "--out-file", cap],
                       capsys)
    assert rc == 0 and json.loads(out) == {"written": 2, "out_file": cap}
    outs = []
    for which in (jcli, pcli):
        pout = str(tmp_path / f"powers-{which.__name__}.raw")
        argv = ["run", "--config", "tiny", "--input-file", cap,
                "--output-file", pout, "--blocks", "2"]
        rc, _, _ = _main(which, argv + (["--device", "cpu"]
                                        if which is pcli else []), capsys)
        assert rc == 0
        outs.append(pout)
    sub = TINY.subband(TINY.n_chan // 2, TINY.n_chan // 2)
    assert os.path.getsize(outs[1]) == 2 * int(np.prod(sub.out_block_shape)) * 4
    _powers_close(*outs)
    for which in (jcli, pcli):
        with pytest.raises(SystemExit, match="DADA capture"):
            which.main(["run", "--config", "tiny", "--subband", "1/2",
                        "--input-file", cap, "--output-file", outs[0]]
                       + (["--device", "cpu"] if which is pcli else []))


def test_launch_subband_processes(tmp_path, capsys):
    """launch: two `dsabf-torch run` children on the CPU (--devices
    cpu,cpu), {i}/{n} templating, the aggregate JSON report; each child's
    product against the JAX package's run of the same subband."""
    n = 2
    width = TINY.n_chan // n
    for i in range(n):
        sb = TINY.subband(i * width, width)
        (tmp_path / f"cap{i}.raw").write_bytes(
            make_noise_block(sb, rms=2.0, seed=20 + i).tobytes())
    rc, out, _ = _main(pcli, [
        "launch", "--subbands", str(n), "--devices", "cpu,cpu", "--",
        "--config", "tiny",
        "--input-file", str(tmp_path / "cap{i}.raw"),
        "--output-file", str(tmp_path / "out{i}.dat"),
    ], capsys)
    assert rc == 0
    rep = _last_json(out)
    assert rep["ok"] and len(rep["subbands"]) == n
    for i, sb_rep in enumerate(rep["subbands"]):
        assert sb_rep["rc"] == 0 and sb_rep["subband"] == f"{i}/{n}"
        assert sb_rep["blocks"] == 1 and sb_rep["dropped"] == 0
        ref = str(tmp_path / f"jax{i}.dat")
        assert jcli.main(["run", "--config", "tiny", "--subband", f"{i}/{n}",
                          "--input-file", str(tmp_path / f"cap{i}.raw"),
                          "--output-file", ref]) == 0
        _powers_close(ref, str(tmp_path / f"out{i}.dat"))


def test_launch_validates_devices_count(capsys):
    for which in (jcli, pcli):
        rc = which.main(["launch", "--subbands", "2", "--devices", "0",
                         "--", "--config", "tiny"])
        assert rc == 2
    assert pcli.main(["launch", "--subbands", "2", "--devices", "cpu,tpu",
                      "--", "--config", "tiny"]) == 2
    assert "card index" in capsys.readouterr().err


def test_launch_failing_child_fails_aggregate(tmp_path, capsys):
    width = TINY.n_chan // 2
    (tmp_path / "cap0.raw").write_bytes(
        make_noise_block(TINY.subband(0, width), rms=2.0, seed=31).tobytes())
    rc, out, _ = _main(pcli, [
        "launch", "--subbands", "2", "--devices", "cpu,cpu", "--",
        "--config", "tiny",
        "--input-file", str(tmp_path / "cap{i}.raw"),
        "--output-file", str(tmp_path / "out{i}.dat"),
    ], capsys)
    assert rc != 0
    rep = _last_json(out)
    assert rep["ok"] is False
    rcs = {s["subband"]: s["rc"] for s in rep["subbands"]}
    assert rcs["0/2"] == 0 and rcs["1/2"] != 0


# ------------- tests/test_zap.py, test_flag.py, test_dada_file.py -------- #

def test_cli_run_zap_and_incoherent_mask(tmp_path, capsys):
    raw = _capture(tmp_path / "cap.raw", TINY, [13])
    files = {}
    for which in (jcli, pcli):
        out = str(tmp_path / f"out-{which.__name__}.dat")
        inco = str(tmp_path / f"inco-{which.__name__}.dat")
        argv = ["run", "--config", "tiny", "--input-file", raw,
                "--output-file", out, "--incoherent-file", inco,
                "--zap", f"0,{TINY.n_chan - 1}"]
        rc, _, _ = _main(which, argv + (["--device", "cpu"]
                                        if which is pcli else []), capsys)
        assert rc == 0
        files[which] = (out, inco)
    f_out, t_out, b_out = TINY.out_block_shape
    p = np.fromfile(files[pcli][0], np.float32).reshape(f_out, t_out, b_out)
    assert (p[[0, -1]] == 0).all() and (p[1:-1] > 0).all()
    _powers_close(files[jcli][0], files[pcli][0])
    q = np.fromfile(files[pcli][1], np.float32).reshape(f_out, -1)
    qj = np.fromfile(files[jcli][1], np.float32).reshape(f_out, -1)
    assert (q[[0, -1]] == 0).all() and (q[1:-1] > 0).all()
    np.testing.assert_allclose(q, qj, rtol=INCO_RTOL)


def test_cli_zap_subband_frame(tmp_path, capsys):
    width = TINY.n_chan // 2
    raw = _capture(tmp_path / "cap1.raw", TINY.subband(width, width), [14])
    outs = []
    for which in (jcli, pcli):
        out = str(tmp_path / f"out1-{which.__name__}.dat")
        argv = ["run", "--config", "tiny", "--subband", "1/2",
                "--input-file", raw, "--output-file", out,
                "--zap", f"0,{width + 1}"]
        rc, _, _ = _main(which, argv + (["--device", "cpu"]
                                        if which is pcli else []), capsys)
        assert rc == 0
        outs.append(out)
    f_out, t_out, b_out = TINY.out_block_shape
    p = np.fromfile(outs[1], np.float32).reshape(f_out // 2, t_out, b_out)
    assert (p[1] == 0).all() and (np.delete(p, 1, axis=0) > 0).all()
    _powers_close(*outs)


@pytest.mark.parametrize("flag", ["--zap", "--flag-ants"])
def test_cli_excision_errors(tmp_path, flag):
    """tests/test_zap.py::test_cli_zap_errors and
    tests/test_flag.py::test_cli_flag_ants_errors: an index out of range
    and an edit of pre-quantized weights exit with the same messages."""
    raw = _capture(tmp_path / "cap.raw", TINY, [2])
    bad = TINY.n_chan if flag == "--zap" else TINY.n_ant_active
    for which in (jcli, pcli):
        with pytest.raises(SystemExit, match="out of range"):
            which.main(["run", "--config", "tiny", "--input-file", raw,
                        "--output-file", str(tmp_path / "o.dat"), flag,
                        str(bad), "--device", "cpu"]
                       [:None if which is pcli else -2])
        with pytest.raises(SystemExit, match="pre-quantized"):
            which.main(["run", "--config", "tiny", "--input-file", raw,
                        "--output-file", str(tmp_path / "o.dat"),
                        "--weights", str(tmp_path / "w.npz"), flag, "0",
                        "--device", "cpu"][:None if which is pcli else -2])


def test_cli_run_flag_ants(tmp_path, capsys):
    raw = tmp_path / "cap.raw"
    wire = make_noise_block(TINY, rms=2.0, seed=24)
    raw.write_bytes(wire.tobytes())
    files = {}
    for which in (jcli, pcli):
        out = str(tmp_path / f"out-{which.__name__}.dat")
        inco = str(tmp_path / f"inco-{which.__name__}.dat")
        argv = ["run", "--config", "tiny", "--input-file", str(raw),
                "--output-file", out, "--incoherent-file", inco,
                "--flag-ants", "1"]
        rc, _, _ = _main(which, argv + (["--device", "cpu"]
                                        if which is pcli else []), capsys)
        assert rc == 0
        files[which] = (out, inco)
    f_out, t_out, b_out = TINY.out_block_shape
    p = np.fromfile(files[pcli][0], np.float32)
    assert (p > 0).all()
    _powers_close(files[jcli][0], files[pcli][0])
    q = np.fromfile(files[pcli][1], np.float32).reshape(f_out, -1)
    np.testing.assert_allclose(
        q, incoherent_power_golden(wire, TINY, flag_ants=(1,)), rtol=1e-5)
    np.testing.assert_array_equal(
        q, np.fromfile(files[jcli][1], np.float32).reshape(f_out, -1))


def test_cli_run_on_dada_file(tmp_path, capsys):
    """A DADA capture's header wins over a mismatched preset geometry, and
    the product equals the raw-file run's and the JAX package's."""
    blocks = [make_noise_block(TINY, rms=2.0, seed=s) for s in range(2)]
    dpath = tmp_path / "cap.dada"
    dada.write_dada_file(dpath, TINY, blocks)
    rpath = _capture(tmp_path / "cap.raw", TINY, range(2))
    outs = {}
    for which in (jcli, pcli):
        dev = ["--device", "cpu"] if which is pcli else []
        out_d = str(tmp_path / f"d-{which.__name__}.out")
        out_r = str(tmp_path / f"r-{which.__name__}.out")
        # The port's config has no TPU tiles (chan_tile).
        tiles = [] if which is pcli else ["--set", "chan_tile=2"]
        rc, out, err = _main(which, [
            "run", "--config", "tiny", "--set", "n_chan=4",
            "--set", "n_chan_total=4", *tiles,
            "--input-file", str(dpath), "--output-file", out_d] + dev,
            capsys)
        assert rc == 0 and _last_json(out)["blocks"] == 2
        assert "DADA header" in err
        rc, _, _ = _main(which, ["run", "--config", "tiny", "--input-file",
                                 rpath, "--output-file", out_r] + dev, capsys)
        assert rc == 0
        np.testing.assert_array_equal(np.fromfile(out_d, np.float32),
                                      np.fromfile(out_r, np.float32))
        outs[which] = out_d
    _powers_close(outs[jcli], outs[pcli])


def test_simulate_to_dada_file_then_run(tmp_path, capsys):
    """simulate --out-file -> run, the product DADA-framed; the port's
    capture file is the JAX package's byte for byte."""
    caps = {}
    for which in (jcli, pcli):
        cap = tmp_path / f"cap-{which.__name__}.dada"
        rc, out, _ = _main(which, ["simulate", "--config", "tiny",
                                   "--blocks", "3", "--source-angle", "0.4",
                                   "--out-file", str(cap)], capsys)
        assert rc == 0 and json.loads(out)["written"] == 3
        caps[which] = cap
    assert caps[jcli].read_bytes() == caps[pcli].read_bytes()
    out = tmp_path / "powers.dada"
    rc, o, _ = _main(pcli, ["run", "--config", "tiny", "--input-file",
                            str(caps[pcli]), "--output-file", str(out),
                            "--device", "cpu"], capsys)
    assert rc == 0 and _last_json(o)["blocks"] == 3
    cfg2, h, off = dada.read_dada_file(out, TINY)
    assert h["PAYLOAD"] == "BEAM_POWERS"
    payload = np.frombuffer(out.read_bytes()[off:], np.float32)
    assert payload.size == 3 * int(np.prod(TINY.out_block_shape))
    assert np.isfinite(payload).all()


# --------------------------- tests/test_dedisperse.py --------------------- #

def _cand_rows(path):
    return [line.split() for line in path.read_text().splitlines()
            if line.strip() and not line.startswith("#")]


def test_cli_run_live_search(tmp_path, capsys):
    """The injected-FRB drill through both CLIs: the live trigger fires,
    the candidate files agree row for row (S/N within 1e-5: the conv plan),
    and the incoherent and multi-beam targets run."""
    cfg = TINY.replace(navg_time=2)
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = 16 * tsamp_out / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2))
    cap = tmp_path / "cap.dada"
    assert pcli.main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                      "--pulse-dm", str(dm), "--pulse-t0", "8",
                      "--pulse-width", "6", "--blocks", "6", "--distinct",
                      "2", "--out-file", str(cap)]) == 0
    common = ["run", "--config", "tiny", "--set", "navg_time=2",
              "--input-file", str(cap), "--search-dm-max", str(3 * dm)]
    rows = {}
    for which in (jcli, pcli):
        cand = tmp_path / f"live-{which.__name__}.cand"
        argv = common + ["--search-beam", str(cfg.n_beams // 2),
                         "--search-threshold", "6",
                         "--search-cand", str(cand)]
        rc, _, err = _main(which, argv + (["--device", "cpu"]
                                          if which is pcli else []), capsys)
        assert rc == 0
        assert "[dsabf] search {" in err and "candidate(s)" in err
        rows[which] = _cand_rows(cand)
    assert rows[pcli] and len(rows[pcli]) == len(rows[jcli])
    for rp, rj in zip(rows[pcli], rows[jcli]):
        assert rp[1:] == rj[1:]
        assert abs(float(rp[0]) - float(rj[0])) <= 1e-5 * abs(float(rj[0])) \
            + 0.01
    assert abs(int(rows[pcli][0][1]) - 8 // cfg.navg_time) <= 8
    rc, _, err = _main(pcli, common + ["--search-beam", "incoherent",
                                       "--search-threshold", "6",
                                       "--device", "cpu"], capsys)
    assert rc == 0 and "incoherent sum" in err and "[dsabf] search {" in err
    rc, _, err = _main(pcli, common + ["--search-beam", "all",
                                       "--search-no-coincidence",
                                       "--search-threshold", "8",
                                       "--device", "cpu"], capsys)
    assert rc == 0 and "all 32 beams" in err and '"beam":' in err


def test_cli_run_live_search_on_the_8bit_product(tmp_path, capsys):
    """``--fil-bits 8`` with the live search: the monitor reads the counts
    the .fil files hold, its first (auto-calibrating) block included, so an
    auto-scaled run finds exactly what a run at the searched beam's scale
    given as ``--fil-scale`` finds, and that run's candidates agree with
    the JAX CLI's row for row (S/N within 1e-5).  No candidate away from
    the pulse comes near the S/N of a first block of float32 powers among
    counts (thousands)."""
    cfg = TINY.replace(navg_time=2)
    beam = cfg.n_beams // 2
    f = cfg.freqs_hz() / 1e6
    tsamp_out = cfg.sample_period_s * cfg.navg_time
    dm = 16 * tsamp_out / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2))
    cap = tmp_path / "cap.dada"
    assert pcli.main(["simulate", "--config", "tiny", "--set", "navg_time=2",
                      "--pulse-dm", str(dm), "--pulse-t0", "8",
                      "--pulse-width", "6", "--blocks", "6", "--distinct",
                      "3", "--out-file", str(cap)]) == 0

    def run(which, name, scale):
        cand = tmp_path / f"{name}.cand"
        argv = ["run", "--config", "tiny", "--set", "navg_time=2",
                "--input-file", str(cap), "--fil-dir", str(tmp_path / name),
                "--fil-bits", "8", "--fil-scale", scale, "--search-dm-max",
                str(3 * dm), "--search-beam", str(beam),
                "--search-threshold", "4", "--search-cand", str(cand)]
        rc, _, err = _main(which, argv + (["--device", "cpu"]
                                          if which is pcli else []), capsys)
        assert rc == 0 and "[dsabf] search {" in err
        return _cand_rows(cand)

    auto = run(pcli, "auto", "auto")
    scales = json.loads((tmp_path / "auto" / "scales.json").read_text())
    scale = repr(scales[f"beam{beam:04d}.fil"])
    fixed = run(pcli, "fixed", scale)
    assert auto and auto == fixed
    jax_rows = run(jcli, "jax", scale)
    assert len(jax_rows) == len(fixed)
    for rp, rj in zip(fixed, jax_rows):
        assert rp[1:] == rj[1:]
        assert abs(float(rp[0]) - float(rj[0])) <= 1e-5 * abs(float(rj[0])) \
            + 0.01
    pulse_t = 8 // cfg.navg_time
    best = max(auto, key=lambda r: float(r[0]))
    assert abs(int(best[1]) - pulse_t) <= 8
    assert all(float(r[0]) < 20 for r in auto
               if abs(int(r[1]) - pulse_t) > 8)
    for name in os.listdir(tmp_path / "fixed"):
        if name.endswith(".fil"):
            _, dj = read_filterbank(tmp_path / "jax" / name)
            _, dp = read_filterbank(tmp_path / "fixed" / name)
            assert dp.dtype == np.uint8 and dj.shape == dp.shape
            assert np.abs(dj.astype(int) - dp.astype(int)).max() <= 1


def test_cli_run_reports_output_ring_drops(tmp_path, capsys):
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    cap = tmp_path / "cap.dada"
    assert pcli.main(["simulate", "--config", "tiny", "--blocks", "6",
                      "--out-file", str(cap)]) == 0
    key = f"tpdrop{os.getpid()}"
    try:
        rc, _, err = _main(pcli, ["run", "--config", "tiny", "--input-file",
                                  str(cap), "--output-key", key, "--nbufs",
                                  "2", "--device", "cpu"], capsys)
        assert rc == 0 and "output ring dropped" in err
    finally:
        try:
            RingBuffer(key, connect_timeout_s=1).destroy()
        except Exception:
            pass


# ------------------- fil, splice, levels, rfi (the host tools) ----------- #

def test_fil_dir_run_fil_and_splice(tmp_path, capsys):
    """run --fil-dir (8-bit, two subbands) through both CLIs, then fil and
    splice: the same JSON records, headers byte-equal but for tstart,
    8-bit data within one count."""
    width = TINY.n_chan // 2
    for which in (jcli, pcli):
        for i in range(2):
            raw = _capture(tmp_path / f"cap{i}.raw",
                           TINY.subband(i * width, width), [40 + i])
            argv = ["run", "--config", "tiny", "--subband", f"{i}/2",
                    "--input-file", raw, "--fil-dir",
                    str(tmp_path / which.__name__ / f"sb{i}"),
                    "--fil-bits", "8", "--fil-scale", "0.001",
                    "--fil-beams", "0,5"]
            rc, _, _ = _main(which, argv + (["--device", "cpu"]
                                            if which is pcli else []),
                             capsys)
            assert rc == 0
    recs = {}
    for which in (jcli, pcli):
        d = tmp_path / which.__name__
        parts = [str(d / f"sb{i}" / "beam0005.fil") for i in (1, 0)]
        (rc, out, _) = _main(which, ["fil", parts[0]], capsys)
        assert rc == 0
        fil = json.loads(out)
        merged = str(d / "merged.fil")
        (rc, out, _) = _main(which, ["splice", *parts, "--out", merged],
                             capsys)
        assert rc == 0
        recs[which] = (fil, json.loads(out), merged)
    (fj, sj, mj), (fp, sp, mp) = recs[jcli], recs[pcli]
    assert {**sj, "out": mp} == sp
    assert set(fj) == set(fp)
    for k in fj:
        if isinstance(fj[k], float):
            assert fp[k] == pytest.approx(fj[k], rel=1e-3, abs=0.05), k
        else:
            assert fp[k] == fj[k], k
    hj, dj = read_filterbank(mj)
    hp, dp = read_filterbank(mp)
    assert {k: v for k, v in hj.items() if k != "tstart"} \
        == {k: v for k, v in hp.items() if k != "tstart"}
    assert dj.shape == dp.shape and dj.dtype == dp.dtype == np.uint8
    assert np.abs(dj.astype(int) - dp.astype(int)).max() <= 1
    assert _main(pcli, ["fil", str(tmp_path / "missing.fil")], capsys)[0] == 1


@pytest.mark.parametrize("cmd", ["levels", "rfi"])
def test_scan_commands_match_jax(tmp_path, capsys, cmd):
    """levels and rfi (with --per-ant) on a capture with a carrier in one
    channel: the same JSON records; and the refusal of both or neither of
    --input-file and --key."""
    blocks = [make_noise_block(TINY, rms=2.0, seed=50 + s) for s in range(2)]
    for b in blocks:
        b.reshape(TINY.wire_block_shape)[:, 3] = 0x77
    cap = tmp_path / "cap.dada"
    dada.write_dada_file(cap, TINY, blocks)
    argv = [cmd, "--config", "tiny", "--input-file", str(cap)]
    if cmd == "rfi":
        argv += ["--per-ant", "--sk-values"]
    (rj, oj, _), (rp, op, _) = _both(argv, capsys)
    assert rj == rp == 0
    j, p = json.loads(oj), json.loads(op)
    assert set(j) == set(p)
    for k in j:
        if isinstance(j[k], list) and j[k] and isinstance(j[k][0], float):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-5)
        elif isinstance(j[k], float):
            assert p[k] == pytest.approx(j[k], rel=1e-4, abs=1e-6), k
        else:
            assert p[k] == j[k], k
    if cmd == "rfi":
        assert 3 in p["flagged"]
    for which in (jcli, pcli):
        assert _main(which, [cmd, "--config", "tiny"], capsys)[0] == 2


@pytest.mark.parametrize("cmd", ["levels", "rfi"])
def test_scan_commands_from_a_ring_match_jax(capsys, cmd):
    """levels and rfi with ``--key``: the blocks of a live ring (the port's
    read on ``--device cpu``), the same JSON records as the JAX CLI's."""
    from dsabeamformer_tpu.ingest.ring import RingBuffer as JaxRing
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    blocks = [make_noise_block(TINY, rms=2.0, seed=60 + s) for s in range(3)]
    recs = {}
    for which, ring_cls, extra in ((jcli, JaxRing, []),
                                   (pcli, RingBuffer, ["--device", "cpu"])):
        key = f"tscan{cmd}{os.getpid()}{which is pcli:d}"
        with ring_cls(key, create=True, nbufs=4,
                      bufsz=TINY.wire_block_bytes) as ring:
            ring.write_header(dada.encode_header(TINY))
            for b in blocks:
                ring.write_block(b)
            ring.set_eod()
            rc, out, _ = _main(which, [cmd, "--config", "tiny", "--key", key,
                                       "--blocks", "3", "--timeout", "2"]
                               + extra, capsys)
        assert rc == 0
        recs[which] = json.loads(out)
    j, p = recs[jcli], recs[pcli]
    assert p["blocks"] == j["blocks"] == 3 and set(j) == set(p)
    for k in j:
        if isinstance(j[k], list) and j[k] and isinstance(j[k][0], float):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, atol=1e-5)
        elif isinstance(j[k], float):
            assert p[k] == pytest.approx(j[k], rel=1e-4, abs=1e-6), k
        else:
            assert p[k] == j[k], k


@pytest.mark.parametrize("cmd", ["weights", "levels", "rfi", "search",
                                 "trace", "beampattern", "calibrate",
                                 "bench"])
def test_device_cpu_and_missing_card(tmp_path, capsys, monkeypatch, cmd):
    """weights, levels, rfi, search, trace, beampattern, calibrate and
    bench take ``--device`` as run does: ``cpu`` runs on the host; ``0``,
    ``cuda:0`` or none with no usable card exits 2 with
    ``resolve_device``'s message and writes nothing."""
    from dsabeamformer_tpu_torch.utils.device import resolve_device

    cap = _capture(tmp_path / "cap.raw", TINY, [70])
    out_file = tmp_path / "w.npz"
    if cmd == "search":
        prod = tmp_path / "p.dada"
        assert pcli.main(["run", "--config", "tiny", "--input-file", cap,
                          "--output-file", str(prod), "--device",
                          "cpu"]) == 0
        out_file = tmp_path / "s.cand"
        argv = ["search", str(prod), "--beam", "all", "--dm-max", "0.001",
                "--cand", str(out_file)]
    elif cmd == "trace":
        out_file = tmp_path / "trace"
        argv = ["trace", "--config", "tiny", "--blocks", "1", "--out",
                str(out_file)]
    elif cmd == "beampattern":
        out_file = tmp_path / "b.png"
        argv = ["beampattern", "--config", "tiny", "--out", str(out_file),
                "--sweep", "32"]
    elif cmd == "calibrate":
        out_file = tmp_path / "cal.npz"
        argv = ["calibrate", "--config", "tiny", "--input-file", cap,
                "--angle", "0", "--out", str(out_file)]
    elif cmd == "bench":
        argv = ["bench", "--config", "tiny", "--blocks", "2"]
    else:
        argv = [cmd, "--config", "tiny"] + (
            ["--out", str(out_file)] if cmd == "weights"
            else ["--input-file", cap])
    rc, out, _ = _main(pcli, argv + ["--device", "cpu"], capsys)
    assert rc == 0 and out.strip()
    if cmd != "search":
        assert json.loads(out)
    shutil.rmtree(out_file, ignore_errors=True)
    out_file.unlink(missing_ok=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device("cuda:0")
    for extra in (["--device", "0"], ["--device", "cuda:0"], []):
        rc, out, err = _main(pcli, argv + extra, capsys)
        assert rc == 2 and out == "" and str(want.value) in err
        assert not out_file.exists()
    rc, _, err = _main(pcli, argv + ["--device", "gpu"], capsys)
    assert rc == 2 and "card index" in err


# ----------------------- the helpers, against the JAX CLI's -------------- #

@pytest.mark.parametrize("meta", [
    {}, {"tstart": 60000.5}, {"MJD_START": "60001.25"},
    {"UTC_START": "2026-10-17-12:00:00", "tstart": 0.0}])
def test_epoch_meta(meta):
    assert pcli._epoch_meta(meta) == jcli._epoch_meta(meta)


@pytest.mark.parametrize("n,dm_max", [(10, 100.0), (262144, 3.0e4),
                                      (262145, 3.5e4)])
def test_dm_grid_error(n, dm_max):
    dms = np.zeros(n)
    assert pcli._dm_grid_error(dms, 1e-3, dm_max) \
        == jcli._dm_grid_error(dms, 1e-3, dm_max)


@pytest.mark.parametrize("spec", ["inco", "incoherent", "all", "ALL", "3",
                                  "3,7,10-12", "0-3"])
def test_parse_beam_target(spec):
    assert pcli._parse_beam_target(spec, 32) \
        == jcli._parse_beam_target(spec, 32)


def test_parse_beam_target_out_of_range():
    for which in (jcli, pcli):
        with pytest.raises(ValueError, match="out of range"):
            which._parse_beam_target("40", 32)


@pytest.mark.parametrize("zap,subband", [("0,7", None), ("1,5-6", "1/2"),
                                         ("0-7", "0/4")])
def test_local_zap_chans(zap, subband):
    """Full-band --zap specs to a process's local channels, as the JAX
    CLI maps them (out-of-subband channels are not this process's)."""
    import argparse

    got = []
    for which in (jcli, pcli):
        args = argparse.Namespace(config="tiny", set=None, subband=subband,
                                  zap=zap)
        cfg = which._load_cfg(args)
        got.append(which._local_zap_chans(cfg, args))
    assert got[0] == got[1]
