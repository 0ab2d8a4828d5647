"""The slice end to end on the CPU: wire bytes with an injected dispersed
pulse in, candidates out.  The port's StreamingBeamformer with a live
SearchMonitor attached against the JAX package's, on the same blocks and
weights: with an 8-bit FilterbankSink (the monitor then searches the uint8
products, after a float32 block 0, as the reference's does) and with no
sink; one beam, a beam set, and the incoherent sum.  Plus
the pulse generator byte for byte."""

import dataclasses

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ingest.generator as jgen
import dsabeamformer_tpu.ingest.sigproc as jsig
import dsabeamformer_tpu.ops.dedisperse as jdd
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ingest.sigproc as psig
import dsabeamformer_tpu_torch.ops.dedisperse as pdd
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu_torch.ingest.generator import make_dispersed_pulse_block

CFG = pcfg.TINY.replace(navg_time=2)
JCFG = jcfg.TINY.replace(navg_time=2)
#: A DM whose sweep across the band is 16 output samples at TINY's cadence.
TSAMP = CFG.sample_period_s * CFG.navg_time
_F = CFG.freqs_hz() / 1e6
DM = 16 * TSAMP / (pcfg.DM_CONST_S * (_F.min() ** -2 - _F.max() ** -2))
TARGET = CFG.n_beams // 2
N_BLOCKS = 8
#: S/N against the reference: the monitor's conv bank rounds in another
#: order than the reference's one-hot convolution.
CONV_SNR_RTOL = 1e-5


@pytest.mark.parametrize("kw", [
    dict(dm=DM, t0_sample=8, width_samples=6, seed=0),
    dict(dm=3 * DM, t0_sample=20, width_samples=2, seed=5, amplitude=3.0,
         noise_rms=1.0),
    dict(dm=DM, t0_sample=4, width_samples=3, seed=2, period_samples=24)],
    ids=["drill", "bright", "train"])
@pytest.mark.parametrize("cfg_name", ["tiny", "dsa10_sub"])
def test_dispersed_pulse_block_equals_jax(kw, cfg_name):
    if cfg_name == "tiny":
        pc, jc = CFG, JCFG
    else:
        pc = pcfg.DSA10.replace(n_chan=8, t_block=512)
        jc = jcfg.DSA10.replace(n_chan=8, t_block=512, time_tile=512)
    angle = pc.beam_angles_rad()[3]
    got = make_dispersed_pulse_block(pc, angle_rad=angle, **kw)
    want = jgen.make_dispersed_pulse_block(jc, angle_rad=angle, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="period_samples"):
        make_dispersed_pulse_block(pc, DM, period_samples=2, width_samples=2)


def _blocks():
    angle = CFG.beam_angles_rad()[TARGET]
    return [make_dispersed_pulse_block(CFG, DM, angle_rad=angle,
                                       t0_sample=8, width_samples=6,
                                       amplitude=5.0, seed=s)
            for s in range(2)]


def _weights():
    qj = jq.prepare_weights(JCFG, jmake_weights(JCFG))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


MONITORS = {
    "beam": dict(beam=TARGET),
    # A coherent point source lights the set's beams through the sidelobes,
    # which the coincidence veto would reject (the reference's CLI drill
    # runs its beam set without it, too).
    "set": dict(beam=[0, 4, TARGET, 24, 28], coincidence=False),
    "incoherent": dict(incoherent=True),
}


@pytest.mark.parametrize("monitor", sorted(MONITORS))
@pytest.mark.parametrize("sink", ["fil8", "none"])
def test_stream_with_monitor_matches_jax(tmp_path, sink, monitor):
    blocks = _blocks()
    qj, qp = _weights()
    dms = pdd.dm_trial_grid(float(_F.min()), float(_F.max()), TSAMP,
                            dm_max=3 * DM)
    kw = dict(threshold=6.0, chunk_t=64, **MONITORS[monitor])
    inco = monitor == "incoherent"
    found, port_scales = {}, None
    for name, pipe, sig, dd, cfg, qw, extra in (
            ("port", ppipe, psig, pdd, CFG, qp, {"device": "cpu"}),
            ("jax", jpipe, jsig, jdd, JCFG, qj, {})):
        fil = sig.FilterbankSink(tmp_path / name, cfg, nbits=8) \
            if sink == "fil8" else None
        if fil is not None and name == "jax":
            # The port's monitor reads the counts the files hold, the
            # auto-calibrating first block's too; the JAX package's reads
            # that block as float32 powers among the later blocks' counts
            # unless its sink's scales are known before it.  Seeded with
            # the port's auto scales, both read the same counts.
            fil._scales.update(port_scales)
        inco_sink = pipe.CollectSink() if inco else None
        bf = pipe.StreamingBeamformer(
            cfg, qw, pipe.SyntheticSource(cfg, blocks, N_BLOCKS), fil,
            depth=2, incoherent_sink=inco_sink)
        mon = dd.SearchMonitor(cfg.freqs_hz() / 1e6, TSAMP, dms, **kw,
                               **extra)
        bf.search_monitor = mon
        stats = bf.run()
        if fil is not None:
            fil.close()
        assert stats.n_blocks == N_BLOCKS
        found[name] = mon
        if fil is not None:
            port_scales = fil.scales
    port, ref = found["port"].candidates, found["jax"].candidates
    assert found["port"].searched_windows == found["jax"].searched_windows
    assert found["port"].rfi_rejected == found["jax"].rfi_rejected
    assert port, "the injected pulse was not found"
    assert len(port) == len(ref)
    for cp, cr in zip(port, ref):
        assert cp.snr == pytest.approx(cr.snr, rel=CONV_SNR_RTOL)
        assert dataclasses.asdict(dataclasses.replace(cp, snr=cr.snr)) \
            == dataclasses.asdict(cr)
    # The drill: pulses every block (t0 8 wire samples = output sample 4 of
    # each 32), at the injected DM, in the pointed beam (or near it).
    best = max(port, key=lambda c: c.snr)
    t_out = CFG.out_block_shape[1]
    assert min(abs(best.t_samp - (k * t_out + 4))
               for k in range(N_BLOCKS)) <= 4
    assert abs(best.dm - DM) <= 2 * (dms[1] - dms[0])
    if monitor == "beam":
        assert best.beam == TARGET


def test_stream_without_sink_leaves_product_on_device_but_feeds_monitor():
    """With no sink the monitor's beams come back on their own: the stream
    keeps no whole-product host buffer."""
    _, qp = _weights()
    dms = pdd.dm_trial_grid(float(_F.min()), float(_F.max()), TSAMP,
                            dm_max=3 * DM)
    bf = ppipe.StreamingBeamformer(
        CFG, qp, ppipe.SyntheticSource(CFG, _blocks(), 2), None)
    seen = []
    mon = pdd.SearchMonitor(CFG.freqs_hz() / 1e6, TSAMP, dms, beam=[1, 2],
                            chunk_t=64, device="cpu")
    mon.observe_selected = lambda seq, sel, inco=None: seen.append(
        (seq, None if sel is None else sel.shape))
    bf.search_monitor = mon
    bf.run()
    t_out = CFG.out_block_shape[1]
    assert seen == [(0, (2, t_out, CFG.n_chan)), (1, (2, t_out, CFG.n_chan))]
