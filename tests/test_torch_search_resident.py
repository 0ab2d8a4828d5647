"""The live search with its window on the device (``ops/dedisperse.
SearchMonitor``) on the CPU at a small size: 48 beams, 64 channels over
DSA-10's band at its 131-us cadence, 61 trials to DM 13, 256-sample windows,
seeded 8-bit counts with dispersed pulses injected.  Each window's peaks and
each beam's candidates against the plain float64 reference
(``tests/torch_search_reference.py``); the same results whatever the beam
groups; a pulse across a block and a window boundary found once; a
sequence gap flushing as before; block 0 turned into counts as the host
rule did; the search's spans and counters in the streaming loop."""

import dataclasses

import numpy as np
import pytest
import torch

import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
import torch_search_reference as R
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.ingest.sigproc import FilterbankSink
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.dedisperse import SearchMonitor
from dsabeamformer_tpu_torch.utils import profiling

OBS = {"f_start_hz": 1.28e9, "bandwidth_hz": 250e6, "n_chan": 64,
       "n_chan_total": 64, "navg_freq": 1, "navg_time": 512}
FREQS = R.freqs_mhz(OBS)
TSAMP = R.tsamp_s(OBS)
DMS = R.dm_grid(FREQS, TSAMP, 13.0, 1.25)
DELAYS = R.delays(FREQS, DMS, TSAMP)
WIDTHS = (1, 2, 4, 8, 16, 32)
N_BEAMS, T_BLK, N_BLK, CHUNK = 48, 64, 16, 256
#: (beam, start at the band's top, trial): A's boxcar ends at the first
#: window's last owned sample and its sweep runs into the next window, B's
#: starts on a block boundary; both sweep over two blocks.
PULSES = ((5, 250, 40), (6, 250, 40), (20, 704, 25))
#: Peak S/N against the float64 reference: the sums are exact (8-bit
#: counts), the float32 normalization and 16-sample blocked cumulative sum
#: over <= 400 samples of |S/N| <= 20 round to ~1e-5 sigma.
SNR_TOL = 1e-4


def _stream(seed=3) -> np.ndarray:
    """``[B, F, T]`` counts: noise around 64, the pulses 8 counts over 4
    samples in each channel at its delay."""
    rng = np.random.default_rng(seed)
    x = np.clip(np.rint(rng.normal(64, 8, (N_BEAMS, 64, T_BLK * N_BLK))),
                0, 255)
    for b, t0, d in PULSES:
        for f in range(64):
            x[b, f, t0 + DELAYS[d, f]:t0 + DELAYS[d, f] + 4] += 8
    return np.clip(x, 0, 255).astype(np.uint8)


def _blocks(x):
    """The ``[F, T, B]`` product blocks of the stream."""
    return [np.ascontiguousarray(x[:, :, i * T_BLK:(i + 1) * T_BLK]
                                 .transpose(1, 2, 0)) for i in range(N_BLK)]


def _monitor(windows=None, **kw):
    return SearchMonitor(FREQS, TSAMP, DMS, beam="all", chunk_t=CHUNK,
                         device="cpu", on_window=None if windows is None
                         else windows.append, **kw)


def _run(x, seqs=None, **kw):
    windows = []
    mon = _monitor(windows, **kw)
    for i, blk in enumerate(_blocks(x)):
        if seqs is None or i in seqs:
            mon.observe(i, blk)
    mon.flush()
    return mon, windows


@pytest.fixture(scope="module")
def stream():
    return _stream()


@pytest.fixture(scope="module")
def searched(stream):
    return _run(stream)


def test_the_grid_and_delays_are_the_monitor_s(searched):
    mon, _ = searched
    assert len(DMS) == 61 and np.array_equal(mon.dms, DMS)
    assert np.array_equal(mon.delays, DELAYS)


def test_peaks_and_candidates_equal_the_reference(stream, searched):
    mon, windows = searched
    assert len(windows) == mon.searched_windows >= 3
    plan = R.plan_delays(DELAYS)
    band_span = DELAYS.max(axis=1)
    for w in windows:
        assert w.beams == list(range(N_BEAMS))
        x = torch.from_numpy(stream[:, :, w.t_base:w.t_base + w.n_samples])
        lim = R.limits(DELAYS, w.n_samples, WIDTHS, w.own)
        series = R.snr_series(R.bank(x, plan), WIDTHS)
        want = R.peaks(series, lim).numpy()
        assert w.peaks.shape == want.shape == (N_BEAMS, len(WIDTHS),
                                               len(DMS))
        assert np.array_equal(np.isinf(w.peaks), np.isinf(want))
        ok = ~np.isinf(want)
        assert np.abs(w.peaks[ok] - want[ok]).max() <= SNR_TOL
        k = min(4, w.n_samples - max(WIDTHS) + 1)
        ref = [R.cluster(p, band_span) for p in
               R.points(series, lim, WIDTHS, k, 7.0, w.t_base)]
        for b in range(N_BEAMS):
            got = w.found[b]
            assert len(got) == len(ref[b]), (w.t_base, b)
            for c in got:
                match = [r for r in ref[b] if R.same_event(
                    dataclasses.asdict(c), r, band_span)]
                assert len(match) == 1
                assert c.snr == pytest.approx(match[0]["snr"], abs=SNR_TOL)


@pytest.mark.parametrize("group", [1, 7, 48])
def test_beam_groups_give_the_same_results(stream, searched, group):
    mon, windows = searched
    other, o_windows = _run(stream, beam_batch=group)
    assert other.candidates == mon.candidates
    assert other.rfi_rejected == mon.rfi_rejected
    assert [w.blocks for w in o_windows] == [w.blocks for w in windows]
    for a, b in zip(o_windows, windows):
        assert np.array_equal(a.peaks, b.peaks)
        assert a.found == b.found


def test_each_pulse_is_found_once(searched):
    mon, windows = searched
    for b, t0, d in PULSES:
        hits = [c for c in mon.candidates
                if c.beam == b and abs(c.t_samp - t0) < 32]
        assert len(hits) == 1, (b, t0, hits)
        assert abs(hits[0].dm_idx - d) <= 2
    # A's boxcar lies in the first window's owned samples, its sweep in the
    # second window's carry; B's in the third window's.
    assert windows[0].own == CHUNK and windows[0].t_base == 0
    assert [w.seqs for w in windows[:3]] == [(0, 5), (4, 9), (8, 13)]


def test_a_sequence_gap_flushes_as_before(stream):
    """Blocks 0-7, a lost block 8, then 9-15: the first part is searched
    and flushed as a stream of its own, the second starts a window's carry
    later on the nominal clock."""
    mon, _ = _run(stream, seqs=set(range(16)) - {8})
    assert mon.gaps == 1
    first, _ = _run(stream, seqs=set(range(8)))
    rest = _monitor()
    for i, blk in enumerate(_blocks(stream)[9:]):
        rest.observe(i, blk)
    rest.flush()
    shift = 8 * T_BLK + rest.overlap
    assert mon.searched_windows == \
        first.searched_windows + rest.searched_windows
    assert mon.candidates == first.candidates + [
        dataclasses.replace(c, t_samp=c.t_samp + shift,
                            time_s=(c.t_samp + shift) * TSAMP)
        for c in rest.candidates]


CFG = pcfg.TINY


def test_block_zero_becomes_the_counts_of_the_host_rule(tmp_path):
    """The first block, float32 before the 8-bit sink's scales exist, is
    turned into counts where its beams are, equal to the host's rule
    ``clip(rint(power * scale), 0, 255)``."""
    qw = pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))
    sink = FilterbankSink(tmp_path, CFG, nbits=8)
    bf = ppipe.StreamingBeamformer(CFG, qw, None, sink)
    powers = np.random.default_rng(5).gamma(
        4.0, 16.0, CFG.out_block_shape).astype(np.float32)
    sink.write(0, powers)
    for beam in (3, [1, 4, 9], "all"):
        bf.search_monitor = mon = SearchMonitor(
            FREQS[:CFG.n_chan], TSAMP, DMS[:2], beam=beam, device="cpu")
        sel = mon.select_beams(torch.from_numpy(powers))
        scales = sink.fused_quant8_scales("cpu").numpy()
        s = scales[beam] if isinstance(beam, int) else \
            scales[mon._labels][:, None, None]
        want = np.clip(np.rint(sel.numpy() * s), 0, 255).astype(np.uint8)
        got = bf._counts_of_selected(sel)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), want)
    sink.close()


SEARCH_SPANS = {"dsabf.search.window", "dsabf.search.bank",
                "dsabf.search.topk", "dsabf.search.cluster",
                "dsabf.search.append", "dsabf.search.observe"}


def _inside(inner, outer):
    return outer["tid"] == inner["tid"] and outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _search_stream(n_blocks=12):
    """The loop on TINY with a 4-beam monitor of windows of 8 samples (two
    blocks of 4) in groups of one beam."""
    qw = pq.prepare_weights(CFG, make_weights(CFG, device="cpu"))
    blocks = [make_noise_block(CFG, rms=2.0, seed=s) for s in range(3)]
    bf = ppipe.StreamingBeamformer(
        CFG, qw, ppipe.SyntheticSource(CFG, blocks, n_blocks),
        ppipe.CollectSink(), depth=2)
    f = CFG.freqs_hz() / 1e6
    bf.search_monitor = SearchMonitor(
        f, CFG.sample_period_s * CFG.navg_time, np.array([0.0]),
        beam=[0, 5, 9, 17], chunk_t=8, widths=(1, 2), beam_batch=1,
        device="cpu")
    return bf


def test_search_spans_nest_and_its_counters_add_up(tmp_path):
    with profiling.trace(tmp_path, "cpu"):
        bf = _search_stream()
        stats = bf.run()
    events = [e for e in profiling.trace_events(tmp_path)
              if e.get("cat") == "user_annotation"]
    spans = {n: [e for e in events if e["name"] == n] for n in SEARCH_SPANS}
    mon = bf.search_monitor
    assert stats.n_blocks == 12
    assert stats.search_windows == mon.searched_windows > 0
    assert stats.search_candidates == len(mon.candidates)
    assert stats.search_rfi_rejected == mon.rfi_rejected
    assert stats.record(CFG)["search_windows"] == mon.searched_windows
    assert 0 < stats.search_s <= stats.sinks_s + stats.wall_s
    # A bank and a top-k a beam group: four groups a window.
    assert len(spans["dsabf.search.bank"]) \
        == len(spans["dsabf.search.topk"]) == 4 * mon.searched_windows
    assert len(spans["dsabf.search.cluster"]) == mon.searched_windows
    assert len(spans["dsabf.search.append"]) == 12
    for child, parent in (("dsabf.search.bank", "dsabf.search.window"),
                          ("dsabf.search.topk", "dsabf.search.window"),
                          ("dsabf.search.cluster", "dsabf.search.window"),
                          ("dsabf.search.append", "dsabf.search.observe"),
                          ("dsabf.search.window", "dsabf.search.observe")):
        assert all(any(_inside(c, p) for p in spans[parent])
                   for c in spans[child]), child
    drains = [e for e in events if e["name"] == "dsabf.loop.drain"]
    assert all(any(_inside(c, d) for d in drains)
               for c in spans["dsabf.search.append"])


def test_the_search_enters_no_record_function_without_a_trace(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no trace")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    bf = _search_stream()
    stats = bf.run()
    assert stats.search_windows == bf.search_monitor.searched_windows > 0
