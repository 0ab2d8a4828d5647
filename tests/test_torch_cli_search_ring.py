"""``dsabf-torch search --key``, the live product-ring consumer, against the
JAX package's ``dsabf search --key`` on the CPU: one ring and the joined
per-subband rings (band order, contiguity, payload and header checks, the
seq-aligned read with skew counting, EOD of one ring, ``--max-idle``),
Stokes rings, and the deployment's topology (``dsabf-torch launch
--subbands 2 ... --output-key`` then ``search --key k0,k1``).  A ring has
one consumer, so each CLI reads rings of its own, filled alike: by its own
package's ``run --output-key`` from one capture, or with the same seeded
blocks.  The bars are ``tests/test_torch_cli_search.py``'s: equal exit
codes and errors, candidate rows one for one (S/N within 1e-5 relative +
0.01)."""

import json
import os

import numpy as np
import pytest

from dsabeamformer_tpu import cli as jcli
from dsabeamformer_tpu_torch import cli as pcli
from dsabeamformer_tpu_torch.config import DM_CONST_S, TINY
from dsabeamformer_tpu_torch.ingest import dada
from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
from dsabeamformer_tpu_torch.pipeline import FileSink, RingSink
from test_torch_cli import _main
from test_torch_cli_search import _errors, _rows, _same_rows

CFG2 = TINY.replace(navg_time=2)
NAVG2 = ["--set", "navg_time=2"]
PID = os.getpid()


def _dm(span):
    f = CFG2.freqs_hz() / 1e6
    tsamp_out = CFG2.sample_period_s * CFG2.navg_time
    return span * tsamp_out / (DM_CONST_S * (f.min() ** -2 - f.max() ** -2))


def _destroy(keys):
    for key in keys:
        try:
            RingBuffer(key, connect_timeout_s=1).destroy()
        except Exception:  # noqa: BLE001 - a ring that was never made
            pass


def _tag(which):
    return "p" if which is pcli else "j"


def _dev(which):
    return ["--device", "cpu"] if which is pcli else []


def _consume(argv_of, capsys):
    """``argv_of(which)`` through each CLI's ``search``: ((rc, out, err)
    JAX, (...) port), with equal exit codes, errors (each CLI's ring names
    aside) and candidate rows."""
    res = [_main(w, ["search", *argv_of(w), *_dev(w)], capsys)
           for w in (jcli, pcli)]
    (rj, oj, ej), (rp, op, ep) = res
    assert rp == rj, (ej, ep)
    assert [e.replace(f"{PID}p", f"{PID}j") for e in _errors(ep, True)] \
        == _errors(ej, False)
    _same_rows(_rows(op), _rows(oj))
    return res


def _simulate(path, *extra):
    assert pcli.main(["simulate", "--config", "tiny", *NAVG2, *extra,
                      "--out-file", str(path)]) == 0


def _produce(which, cap, key, *extra):
    """``run --output-key`` of ``which`` over a capture file."""
    assert which.main(["run", "--config", "tiny", *NAVG2, "--input-file",
                       str(cap), "--output-key", key, "--nbufs", "10",
                       *extra, *_dev(which)]) == 0


def test_cli_search_live_ring(tmp_path, capsys):
    """Each package's run writes products into a ring and its search
    attaches and finds the drill pulse, the same rows from both; a
    non-product ring, files with --key, and neither are rejected alike."""
    dm = _dm(16)
    cap = tmp_path / "cap.dada"
    _simulate(cap, "--pulse-dm", str(dm), "--pulse-t0", "8", "--pulse-width",
              "6", "--blocks", "6", "--distinct", "2")
    keys = {w: f"ttsr{PID}{_tag(w)}" for w in (jcli, pcli)}
    try:
        for w, key in keys.items():
            _produce(w, cap, key)
        capsys.readouterr()
        (_, _, ej), (rc, out, err) = _consume(lambda w: [
            "--key", keys[w], "--beam", "all", "--no-coincidence",
            "--dm-max", str(2 * dm), "--threshold", "8", "--widths", "1",
            "2", "4", "--cand", str(tmp_path / f"{_tag(w)}.cand"),
            "--timeout", "2"], capsys)
        assert rc == 0 and "attached to 1 ring(s)" in err
        rows = _rows(out)
        assert rows and int(rows[0][9]) in (CFG2.n_beams // 2 - 1,
                                            CFG2.n_beams // 2)
        body = (tmp_path / "p.cand").read_text()
        assert f"# ring = {keys[pcli]}" in body and "# live = True" in body
    finally:
        _destroy(keys.values())
    key2 = f"ttsrw{PID}"
    with RingBuffer(key2, create=True, nbufs=2, bufsz=1024) as r:
        r.write_header("HDR_VERSION 1.0\nNCHAN 8\n")
        (rj, _, _), (rp, _, ep) = _consume(
            lambda w: ["--key", key2, "--dm-max", "10", "--timeout", "1"],
            capsys)
        assert rj == rp == 1 and "not a beam product" in ep
        r.destroy()
    for argv in ([str(cap), "--key", "x", "--dm-max", "10"],
                 ["--dm-max", "10"], ["--key", " , ", "--dm-max", "10"],
                 ["--key", "a,a", "--dm-max", "10"]):
        (rj, _, _), (rp, _, _) = _consume(lambda w: argv, capsys)
        assert rj == rp == 1


def test_cli_search_live_ring_join(tmp_path, capsys):
    """Two per-subband producers feed one joined consumer, keys given in
    reverse band order: band-ordered, contiguity checked, the joined full
    band searched; two copies of one subband are refused as not
    contiguous."""
    dm = _dm(2)
    caps = []
    for i in range(2):
        caps.append(tmp_path / f"cap{i}.dada")
        _simulate(caps[-1], "--subband", f"{i}/2", "--pulse-dm", str(dm),
                  "--pulse-t0", "8", "--pulse-width", "6", "--blocks", "6",
                  "--distinct", "2")
    keys = {w: [f"ttsj{PID}{_tag(w)}_{i}" for i in range(2)]
            for w in (jcli, pcli)}
    dups = {w: f"ttsj{PID}{_tag(w)}_dup" for w in (jcli, pcli)}
    try:
        for w in (jcli, pcli):
            for i in range(2):
                _produce(w, caps[i], keys[w][i])
            _produce(w, caps[0], dups[w])
        capsys.readouterr()
        (_, _, _), (rc, out, err) = _consume(lambda w: [
            "--key", f"{keys[w][1]},{keys[w][0]}", "--beam", "all",
            "--no-coincidence", "--dm-max", str(4 * dm), "--threshold", "8",
            "--widths", "1", "2", "4", "--timeout", "2"], capsys)
        assert rc == 0 and "attached to 2 ring(s)" in err
        assert f"joined {CFG2.n_chan // CFG2.navg_freq} chan" in err
        rows = _rows(out)
        assert rows and int(rows[0][9]) in (CFG2.n_beams // 2 - 1,
                                            CFG2.n_beams // 2)
        assert abs(int(rows[0][1]) - 8 // CFG2.navg_time) <= 8
        (rj, _, _), (rp, _, ep) = _consume(lambda w: [
            "--key", f"{keys[w][0]},{dups[w]}", "--dm-max", str(4 * dm),
            "--timeout", "1"], capsys)
        assert rj == rp == 1 and "not band-contiguous" in ep
    finally:
        _destroy([k for ks in keys.values() for k in ks]
                 + list(dups.values()))


def test_cli_search_join_one_ring_eods_early(tmp_path, capsys):
    """One subband producer ends early: the consumer searches the common
    prefix, flushes and exits cleanly."""
    caps = []
    for i, blocks in enumerate((6, 3)):
        caps.append(tmp_path / f"cap{i}.dada")
        _simulate(caps[-1], "--subband", f"{i}/2", "--blocks", str(blocks),
                  "--distinct", "2")
    keys = {w: [f"ttse{PID}{_tag(w)}_{i}" for i in range(2)]
            for w in (jcli, pcli)}
    try:
        for w in (jcli, pcli):
            for i in range(2):
                _produce(w, caps[i], keys[w][i])
        capsys.readouterr()
        (_, _, ej), (rc, _, err) = _consume(lambda w: [
            "--key", ",".join(keys[w]), "--beam", "0", "--dm-max", "5",
            "--threshold", "8", "--widths", "1", "2", "--timeout", "2"],
            capsys)
        assert rc == 0 and "3 block(s)" in err and "3 block(s)" in ej
    finally:
        _destroy([k for ks in keys.values() for k in ks])


def _fill(key, sub, n_blocks, products="power", rng=None, inco=False):
    """A ring of ``sub``'s product blocks (zeros, or seeded noise), header
    committed, EOD set."""
    fo, to, bo = sub.out_block_shape
    shape = (fo, to) if inco else (fo, to, 4, bo) if products == "stokes" \
        else (fo, to, bo)
    ring = RingBuffer(key, create=True, nbufs=max(4, n_blocks + 2),
                      bufsz=int(np.prod(shape)) * 4)
    if inco:
        ring.write_header(dada.encode_header(
            sub, PAYLOAD="INCOHERENT_POWER", OUT_DTYPE="float32",
            OUT_NCHAN=fo, OUT_NTIME=to))
        for _ in range(n_blocks):
            ring.write_block(np.zeros(shape, np.float32))
    else:
        sink = RingSink(ring, sub, products=products)
        for seq in range(n_blocks):
            blk = (np.zeros(shape, np.float32) if rng is None
                   else rng.standard_normal(shape).astype(np.float32))
            sink.write(seq, blk)
    ring.set_eod()
    return ring


@pytest.mark.parametrize("case", ["beams", "payloads", "stokes_plane",
                                  "beam_range", "inco_beam"])
def test_cli_search_join_mismatched_headers(capsys, case):
    """Rings whose headers disagree beyond the channel axis, mixed
    payloads, a Stokes plane from a power ring, a beam past the ring's and
    a beam of an incoherent ring are refused alike."""
    width = CFG2.n_chan // 2
    sub0, sub1 = CFG2.subband(0, width), CFG2.subband(width, width)
    rings, keys = [], {}
    try:
        for w in (jcli, pcli):
            k = [f"ttsm{PID}{_tag(w)}_{i}" for i in range(2)]
            if case == "beams":
                rings += [_fill(k[0], sub0, 1),
                          _fill(k[1], sub1.replace(
                              n_beams=CFG2.n_beams // 2), 1)]
            elif case == "payloads":
                rings += [_fill(k[0], sub0, 1), _fill(k[1], sub1, 1,
                                                      inco=True)]
            elif case == "inco_beam":
                rings += [_fill(k[0], sub0, 1, inco=True)]
                k = k[:1]
            else:
                rings += [_fill(k[0], sub0, 1)]
                k = k[:1]
            keys[w] = k
        extra = {"stokes_plane": ["--stokes", "Q"],
                 "beam_range": ["--beam", "99"],
                 "inco_beam": ["--beam", "3"]}.get(case, [])
        (rj, _, _), (rp, _, ep) = _consume(lambda w: [
            "--key", ",".join(keys[w]), "--dm-max", "5", "--timeout", "1",
            *extra], capsys)
        assert rj == rp == 1
        want = {"beams": "disagree beyond the channel axis",
                "payloads": "mixed payloads", "stokes_plane": "no Stokes Q",
                "beam_range": "out of range",
                "inco_beam": "no beam axis"}[case]
        assert want in ep
    finally:
        for r in rings:
            r.destroy()


def test_cli_search_join_skew_candidate_straddles(capsys):
    """One ring lost its first 3 blocks: the join counts the skew, skips
    the other ring's stale blocks, and finds a pulse wholly after the
    forced join, as the JAX consumer does."""
    width = CFG2.n_chan // 2
    subs = [CFG2.subband(0, width), CFG2.subband(width, width)]
    t_out = CFG2.t_block // CFG2.navg_time
    pulse_t0, pulse_w = 130, 6
    keys = {w: [f"ttss{PID}{_tag(w)}_{i}" for i in range(2)]
            for w in (jcli, pcli)}
    rings = []
    try:
        for w in (jcli, pcli):
            rng = np.random.default_rng(7)
            for i, sub in enumerate(subs):
                fo, to, bo = sub.out_block_shape
                ring = RingBuffer(keys[w][i], create=True, nbufs=8,
                                  bufsz=fo * to * bo * 4)
                rings.append(ring)
                sink = RingSink(ring, sub, products="power")
                for seq in range(6):
                    blk = rng.standard_normal((fo, to, bo)).astype(
                        np.float32)
                    lo, hi = seq * t_out, (seq + 1) * t_out
                    a, b = max(pulse_t0, lo), min(pulse_t0 + pulse_w, hi)
                    if a < b:
                        blk[:, a - lo:b - lo, 0] += 4.0
                    sink.write(seq, blk)
                ring.set_eod()
            with RingBuffer(keys[w][1], connect_timeout_s=1) as r1:
                for _ in range(3):
                    assert r1.read_block(timeout_s=1) is not None
        capsys.readouterr()
        (_, _, ej), (rc, out, err) = _consume(lambda w: [
            "--key", ",".join(keys[w]), "--beam", "0", "--dm-max", "5",
            "--threshold", "8", "--widths", "1", "2", "4", "--timeout",
            "2"], capsys)
        assert rc == 0
        for e in (err, ej):
            assert "join skew" in e and "skipped" in e and "3 block(s)" in e
        assert [l.split(": ", 1)[1] for l in err.splitlines()
                if l.startswith("# ring")] \
            == [l.split(": ", 1)[1] for l in ej.splitlines()
                if l.startswith("# ring")]
        rows = _rows(out)
        assert rows
        t_found = int(rows[0][1])
        assert abs((t_found % (3 * t_out)) - (pulse_t0 - 3 * t_out)) <= 8
    finally:
        for r in rings:
            r.destroy()


def test_cli_search_live_ring_stokes(tmp_path, capsys):
    """Each package's Stokes run into a ring, searched (plane I, and V) by
    its consumer: the same rows."""
    dm = _dm(16)
    cap = tmp_path / "cap.dada"
    _simulate(cap, "--pulse-dm", str(dm), "--pulse-t0", "8", "--pulse-width",
              "6", "--blocks", "6", "--distinct", "2")
    for plane in ("I", "V"):
        keys = {w: f"ttst{PID}{_tag(w)}{plane}" for w in (jcli, pcli)}
        try:
            for w, key in keys.items():
                _produce(w, cap, key, "--products", "stokes")
            capsys.readouterr()
            (_, _, _), (rc, out, err) = _consume(lambda w: [
                "--key", keys[w], "--beam", "all", "--no-coincidence",
                "--dm-max", str(2 * dm), "--threshold", "8", "--widths",
                "1", "2", "4", "--timeout", "2", "--stokes", plane], capsys)
            assert rc == 0 and "BEAM_STOKES_IQUV" in err
            if plane == "I":
                rows = _rows(out)
                assert rows and int(rows[0][9]) in (CFG2.n_beams // 2 - 1,
                                                    CFG2.n_beams // 2)
        finally:
            _destroy(keys.values())


def test_launch_ring_topology_joined_search_equals_fullband(tmp_path,
                                                            capsys):
    """The deployment's topology on the CPU: ``dsabf-torch launch
    --subbands 2 --devices cpu,cpu`` supervises two per-subband ``run``
    children writing product rings, and ``dsabf-torch search --key k0,k1``
    reports, row for row, what ``dsabf search joined.dada --stream``
    reports on the same subbands' products joined along the channel
    axis."""
    dm = _dm(2)
    flags = ["--beam", "all", "--no-coincidence", "--dm-max", str(4 * dm),
             "--threshold", "8", "--widths", "1", "2", "4", "--timeout", "2"]
    for i in range(2):
        cap = tmp_path / f"cap{i}.dada"
        _simulate(cap, "--subband", f"{i}/2", "--pulse-dm", str(dm),
                  "--pulse-t0", "8", "--pulse-width", "6", "--blocks", "6",
                  "--distinct", "2")
        (tmp_path / f"cap{i}.raw").write_bytes(
            cap.read_bytes()[dada.DADA_HDR_SIZE:])
    keys = [f"tttopo{PID}_{i}" for i in range(2)]
    try:
        rc, out, _ = _main(pcli, [
            "launch", "--subbands", "2", "--devices", "cpu,cpu", "--",
            "--config", "tiny", *NAVG2, "--input-file",
            str(tmp_path / "cap{i}.raw"), "--output-key",
            f"tttopo{PID}_" + "{i}", "--nbufs", "12"], capsys)
        assert rc == 0
        rep = json.loads(out.strip().splitlines()[-1])
        assert rep["ok"] and all(s["blocks"] == 6 and not s["dropped"]
                                 for s in rep["subbands"])
        rc, out, err = _main(pcli, ["search", "--key", ",".join(keys),
                                    *flags, "--device", "cpu"], capsys)
        assert rc == 0 and "attached to 2 ring(s)" in err
        rows_live = _rows(out)
        assert rows_live
    finally:
        _destroy(keys)
    prods = []
    for i in range(2):
        prod = tmp_path / f"prod{i}.dada"
        assert pcli.main(["run", "--config", "tiny", *NAVG2, "--subband",
                          f"{i}/2", "--input-file",
                          str(tmp_path / f"cap{i}.raw"), "--output-file",
                          str(prod), "--device", "cpu"]) == 0
        prods.append(np.asarray(dada.read_product_file(prod)[1]))
    joined = np.concatenate(prods, axis=1)
    jpath = tmp_path / "joined.dada"
    sink = FileSink(jpath, CFG2, products="power")
    for i in range(joined.shape[0]):
        sink.write(i, joined[i])
    sink.close()
    rc, out, _ = _main(jcli, ["search", str(jpath), "--stream", *flags],
                       capsys)
    assert rc == 0
    _same_rows(rows_live, _rows(out))
