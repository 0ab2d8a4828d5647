"""The port's multi-process deployment (``parallel/multihost.py``) on the CPU:
pods of ``tests/torch_multihost_worker.py`` processes under ``gloo``
(tests/test_multihost.py's shapes: 2 x 2 ``tiny``, 4 x 2 ``dsa110s``, the
streaming update), each process's own subband products held against the
JAX package's ``sharded_beamformer`` over the whole band (within JAX_RTOL)
and the float64 golden model, the all-reduced band against the band's sum;
the refusals (a world size that does not divide the channels, a full-band
block fed to a subband process, an RFI monitor); and the subband
arithmetic against JAX's.  The workers run with packages named jax,
jaxlib, ml_dtypes and dsabeamformer_tpu that raise on import first on their
path: they import only the port."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.parallel.multihost as jmh
import dsabeamformer_tpu.parallel.sharding as jsh
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.parallel.multihost as pmh
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import weights_numpy_golden
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.utils.testing import relative_power_error

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_multihost_worker.py"
#: Port against JAX on identical wire and weights (float32 order only).
JAX_RTOL = 1e-6
#: The band against the product's own channel sum (the JAX test's bar).
BAND_RTOL = 1e-5
#: The worker's wire seed, second table's calibration, stream length and
#: update position (tests/torch_multihost_worker.py).
WIRE_SEED, CAL_SEED, N_STREAM, UPDATE_AT = 9, 5, 8, 2

PRESETS = {
    "tiny": (pcfg.TINY, jcfg.TINY),
    "dsa110s": (pcfg.DSA110.replace(n_chan=16, n_chan_total=2048,
                                    t_block=64, n_beams=64),
                jcfg.DSA110.replace(n_chan=16, n_chan_total=2048,
                                    t_block=64, time_tile=32, chan_tile=2,
                                    n_beams=64)),
}


def _poison(root: Path) -> Path:
    for name in ("jax", "jaxlib", "ml_dtypes", "dsabeamformer_tpu"):
        (root / name).mkdir(parents=True, exist_ok=True)
        (root / name / "__init__.py").write_text(
            f"raise ImportError('the worker imported {name}')\n")
    return root


def _tables(jc, tmp_path) -> tuple:
    """The JAX package's two tables, and the npz files the workers load."""
    tabs, paths = [], []
    for i, cal in enumerate((None, JCal.random(jc, seed=CAL_SEED))):
        qw = jq.quantize_weights(jmake_weights(jc, cal=cal), jc.weight_mode,
                                 jc.a_compute)
        paths.append(str(tmp_path / f"w{i}.npz"))
        jq.save_quant_weights(paths[-1], qw)
        tabs.append(qw)
    return tabs, ",".join(paths)


def run_pod(tmp_path, n_proc, slots, preset, mode, weights=None,
            timeout_s=240):
    """Spawn the pod, wait for every worker, return their results."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{_poison(tmp_path / 'poison')}{os.pathsep}{REPO}"
    env["OMP_NUM_THREADS"] = "2"
    out = tmp_path / f"pod-{preset}-{mode}"
    out.mkdir()
    args = ["--coordinator", f"localhost:{port}", "--world", str(n_proc),
            "--slots", str(slots), "--preset", preset, "--mode", mode,
            "--out", str(out)] + (["--weights", weights] if weights else [])
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), *args, "--rank", str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n_proc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"proc {r} OK" in log, \
            f"proc {r} exit {p.returncode}:\n{log[-3000:]}"
    results = []
    for r in range(n_proc):
        npz, js = out / f"proc{r}.npz", out / f"proc{r}.json"
        results.append({**(dict(np.load(npz)) if npz.exists() else {}),
                        **(json.loads(js.read_text()) if js.exists()
                           else {})})
    return results


def _jax_product(jc, n_dev, qw, wire):
    """JAX's sharded product and band over ``n_dev`` virtual devices."""
    mesh = jsh.make_mesh(n_dev)
    step = jsh.sharded_beamformer(jc, mesh, with_band_power=True)
    p, band = step(jax.device_put(jgemm.device_wire_view(wire, jc),
                                  jsh.sharded_wire_sharding(jc, mesh)),
                   jsh.place_weights(qw, mesh))
    return np.asarray(p), np.asarray(band)


def _check_step(res, pc, jc, n_dev, qw, wire):
    ref, jband = _jax_product(jc, n_dev, qw, wire)
    gold = beamform_block_ref(weights_numpy_golden(pc), wire,
                              pc.input_layout, pc.navg_time, pc.navg_freq)
    covered = []
    for r in res:
        sl = slice(int(r["chan_start"]), int(r["chan_start"] + r["n_chan"]))
        covered += list(range(pc.n_chan))[sl]
        assert relative_power_error(r["step_out"], ref[sl]) <= JAX_RTOL
        assert relative_power_error(r["step_out"], gold[sl]) <= 1e-3
        np.testing.assert_allclose(r["step_band"], jband, rtol=JAX_RTOL)
        np.testing.assert_allclose(r["step_band"], ref.sum(axis=(0, 2)),
                                   rtol=BAND_RTOL)
    assert covered == list(range(pc.n_chan))


@pytest.fixture(scope="module")
def dsa110s_pod(tmp_path_factory):
    """4 processes x 2 slots over the DSA-110 structure: one step and the
    8-block stream with its update, in one pod."""
    tmp = tmp_path_factory.mktemp("dsa110s")
    pc, jc = PRESETS["dsa110s"]
    tabs, paths = _tables(jc, tmp)
    res = run_pod(tmp, 4, 2, "dsa110s", "step+stream", paths,
                  timeout_s=300)
    return pc, jc, tabs, res


def test_two_processes_tiny(tmp_path):
    """2 x 2 ``tiny``: each process's subband product and the all-reduced
    band; then the multihost stream's refusals in the same processes."""
    pc, jc = PRESETS["tiny"]
    tabs, paths = _tables(jc, tmp_path)
    res = run_pod(tmp_path, 2, 2, "tiny", "step+refuse", paths)
    _check_step(res, pc, jc, 4, tabs[0],
                make_noise_block(pc, rms=2.0, seed=WIRE_SEED))
    for r in res:
        assert "neither" in r["full_band_block"]
        assert "no RFI monitor" in r["rfi_monitor"] \
            and "ROADMAP.md" in r["rfi_monitor"]
        assert "full-band table" in r["subband_table"]


def test_world_size_must_divide_channels(tmp_path):
    """3 processes over ``tiny``'s 8 channels: every one refuses, with the
    JAX package's message."""
    res = run_pod(tmp_path, 3, 1, "tiny", "refuse")
    with pytest.raises(ValueError) as want:
        jmh.host_subbands(jcfg.TINY, 3)
    assert [r["indivisible"] for r in res] == [str(want.value)] * 3


def test_deployment_shape_step(dsa110s_pod):
    """The DSA-110 deployment shape: 8 slots over 4 processes, the
    128-slot K dim and the 2048-channel band frame, the band summed across
    processes."""
    pc, jc, tabs, res = dsa110s_pod
    _check_step(res, pc, jc, 8, tabs[0],
                make_noise_block(pc, rms=2.0, seed=WIRE_SEED))


def test_streaming_with_update(dsa110s_pod):
    """Each process streams its subband for 8 blocks with a weight update
    at the drain of block 2: every block within JAX_RTOL of one of JAX's
    two regimes (never back to the first), the swap at the same block in
    every process, the band the all-reduced sum of the regime's product."""
    pc, jc, tabs, res = dsa110s_pod
    wire = make_noise_block(pc, rms=2.0, seed=WIRE_SEED)
    refs = [_jax_product(jc, 8, qw, wire)[0] for qw in tabs]
    golds = [beamform_block_ref(
        weights_numpy_golden(pc, cal=cal), wire, pc.input_layout,
        pc.navg_time, pc.navg_freq)
        for cal in (None, CalTable(gains=JCal.random(jc,
                                                     seed=CAL_SEED).gains))]
    swaps = set()
    for r in res:
        sl = slice(int(r["chan_start"]), int(r["chan_start"] + r["n_chan"]))
        assert list(r["stream_seq"]) == list(range(N_STREAM))
        first_new = None
        for seq, p, band in zip(r["stream_seq"], r["stream_out"],
                                r["stream_band"]):
            errs = [relative_power_error(p, ref[sl]) for ref in refs]
            regime = int(np.argmin(errs))
            assert errs[regime] <= JAX_RTOL, (seq, errs)
            assert regime or first_new is None, f"block {seq} reverted"
            if regime and first_new is None:
                first_new = int(seq)
            assert relative_power_error(p, golds[regime][sl]) <= 1e-3
            np.testing.assert_allclose(band, refs[regime].sum(axis=(0, 2)),
                                       rtol=BAND_RTOL)
        assert first_new is not None \
            and UPDATE_AT + 1 <= first_new <= UPDATE_AT + 3
        swaps.add(first_new)
    assert len(swaps) == 1


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_subbands_as_jax(n_hosts):
    """host_subbands partitions the band as the JAX package's, with each
    subband's frequencies the matching slice of the full band's."""
    mine = pmh.host_subbands(pcfg.DSA10, n_hosts)
    theirs = jmh.host_subbands(jcfg.DSA10, n_hosts)
    assert [(s.host_index, s.n_hosts, s.chan_start, s.n_chan)
            for s in mine] == [(s.host_index, s.n_hosts, s.chan_start,
                                s.n_chan) for s in theirs]
    full = pcfg.DSA10.freqs_hz()
    for s, t in zip(mine, theirs):
        np.testing.assert_array_equal(s.config(pcfg.DSA10).freqs_hz(),
                                      t.config(jcfg.DSA10).freqs_hz())
        np.testing.assert_array_equal(
            s.config(pcfg.DSA10).freqs_hz(),
            full[s.chan_start:s.chan_start + s.n_chan])
    with pytest.raises(ValueError, match="not divisible by 7 hosts"):
        pmh.host_subbands(pcfg.DSA10, 7)


def test_single_process_defaults():
    """Without a process group the process is host 0 of 1 (as JAX outside
    a pod)."""
    sub = pmh.my_subband(pcfg.TINY)
    assert (sub.host_index, sub.n_hosts, sub.chan_start, sub.n_chan) \
        == (0, 1, 0, pcfg.TINY.n_chan)
