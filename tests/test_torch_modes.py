"""The weight modes int12, int13, bf16, bf16x2 and f32 of the port (its
plain versions, which a CPU tensor takes) against the JAX package's Pallas
kernels in interpret mode and the float64 golden model: quantized terms,
``beamform_power`` / ``beamform_stokes`` / ``beamform_voltages``, the side
outputs, the streaming loop, the kernels' path and shared-memory arithmetic,
and the weight tables carried across."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.ops.gemm as jgemm
import dsabeamformer_tpu.ops.quantize as jq
import dsabeamformer_tpu.pipeline as jpipe
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
import dsabeamformer_tpu_torch.pipeline as ppipe
from dsabeamformer_tpu.models.calibration import CalTable as JCal
from dsabeamformer_tpu.models.weights import make_weights as jmake_weights
from dsabeamformer_tpu.models.weights import zap_weights as jzap_weights
from dsabeamformer_tpu.ops.rfi import RFIMonitor as JMonitor
from dsabeamformer_tpu_torch.ingest.generator import (
    make_noise_block,
    make_random_bytes_block,
)
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import (
    make_weights,
    weights_numpy_golden,
    zap_weights,
)
from dsabeamformer_tpu_torch.ops.cplx import CVec
from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.utils.testing import assert_power_close

NEW_MODES = ("int12", "int13", "bf16", "bf16x2", "f32")
INT_MODES = ("int12", "int13")

#: Integer modes, port vs JAX on identical wire and terms: the GEMM is the
#: same integer in both, and the plain version mirrors XLA's detection
#: arithmetic, so power and voltages are equal to the bit; the Stokes cross
#: terms differ by float32 rounding, held to this share of the I peak.
STOKES_ATOL = 1e-6
#: Float modes: the float32 K-sum runs in XLA's order there and in the CPU
#: BLAS's here; held to this share of the block's peak.
FLOAT_ATOL = 2e-6

GEOMS = {
    "tiny": (jcfg.TINY, pcfg.TINY),
    "dsa10_small": (jcfg.DSA10.replace(n_chan=8, t_block=64, time_tile=64),
                    pcfg.DSA10.replace(n_chan=8, t_block=64)),
    # One narrow a_compute-128 geometry (the DSA-110 antenna axis).
    "wide": (jcfg.DSA110.replace(n_chan=4, t_block=32, time_tile=32,
                                 n_beams=32, n_ant_compute=128),
             pcfg.DSA110.replace(n_chan=4, t_block=32, n_beams=32,
                                 n_ant_compute=128)),
}


def _cfgs(geom, mode, **kw):
    return tuple(c.replace(weight_mode=mode, **kw) for c in GEOMS[geom])


def _carried_weights(jc, seed=5):
    """The JAX package's quantized weights, and the same bits and scales as
    the port's."""
    qj = jq.prepare_weights(jc, jmake_weights(jc, cal=JCal.random(jc, seed=seed)))
    qp = pq.quant_weights_from_numpy([np.asarray(t) for t in qj.terms],
                                     np.asarray(qj.scales), device="cpu")
    return qj, qp


def _close(got, want, mode, peak=None):
    """Equal to the bit for the integer modes (unless ``peak`` is given: the
    Stokes bar), within FLOAT_ATOL of the peak for the float ones."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if mode in INT_MODES and peak is None:
        np.testing.assert_array_equal(got, want)
        return
    scale = np.abs(want).max() if peak is None else peak
    atol = (STOKES_ATOL if mode in INT_MODES else FLOAT_ATOL) * scale
    assert np.abs(got - want).max() <= atol


# ------------------------------ quantizers ------------------------------ #

@pytest.mark.parametrize("mode", NEW_MODES)
def test_wide_quantizers_byte_identical(mode):
    """The a_compute-128 geometry (test_torch_weights.py holds tiny, dsa10
    and dsa10c, three seeds each)."""
    jc, _ = _cfgs("wide", mode)
    wc = np.asarray(jq.cat_weights(
        jmake_weights(jc, cal=JCal.random(jc, seed=1, amp_sigma=0.5)),
        jc.a_compute))
    jterms, jscales = jq._QUANTIZERS[mode](wc)
    pterms, pscales = pq._QUANTIZERS[mode](torch.from_numpy(wc.copy()))
    for a, b in zip(jterms, pterms):
        assert tuple(b.shape) == (jc.n_chan, jc.gemm_k, 2 * jc.n_beams)
        np.testing.assert_array_equal(
            pq._term_to_numpy(b).view(np.uint8),
            np.ascontiguousarray(np.asarray(a)).view(np.uint8))
    np.testing.assert_array_equal(pscales.numpy(), np.asarray(jscales))


def test_bf16x2_residual_is_not_zero():
    """lo = bf16(wc - bf16(wc)) carries the next 8 bits: a compiler that
    elides the rounding of hi would leave it all zero."""
    _, pc = _cfgs("tiny", "bf16x2")
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    hi, lo = (t.float() for t in qw.terms)
    assert qw.terms[1].dtype == torch.bfloat16 and bool((lo != 0).any())
    assert float(lo.abs().max()) <= float(hi.abs().max()) * 2.0 ** -8
    assert torch.equal(qw.scales, torch.ones(pc.n_chan, 2))


@pytest.mark.parametrize("mode,bound", [
    # The JAX package's bounds (its tests/test_quantize.py): 12-bit x16
    # folding, s = amax/2040, residual <= s/2 => 2.45e-4; int13's s =
    # amax/4318 halves that.
    ("int12", 3.0e-4), ("int13", 1.5e-4), ("bf16", 1.0 / 200),
    ("bf16x2", 1.0 / 50000), ("f32", 1e-7),
])
def test_dequantize_error_bound(mode, bound):
    w = make_weights(pcfg.TINY, device="cpu")
    wc = pq.cat_weights(w)
    qw = pq.quantize_weights(w, mode)
    approx = qw.dequantize(mode if mode in INT_MODES else "linear")
    err = float((approx - wc).abs().max() / wc.abs().max())
    assert err <= bound, f"{mode}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("mode", INT_MODES)
def test_dequantize_matches_jax(mode):
    jc, _ = _cfgs("tiny", mode)
    qj, qp = _carried_weights(jc)
    np.testing.assert_array_equal(qp.dequantize(mode).numpy(),
                                  np.asarray(qj.dequantize(mode)))


def test_term_counts_and_shapes():
    w = make_weights(pcfg.TINY, device="cpu")
    f, b, a = w.shape
    for mode, n, k, dtype in [("int12", 1, 4 * a, torch.int8),
                              ("int13", 1, 8 * a, torch.int8),
                              ("bf16", 1, 2 * a, torch.bfloat16),
                              ("bf16x2", 2, 2 * a, torch.bfloat16),
                              ("f32", 1, 2 * a, torch.float32)]:
        qw = pq.quantize_weights(w, mode)
        assert qw.n_terms == n and tuple(qw.scales.shape) == (f, n)
        for t in qw.terms:
            assert tuple(t.shape) == (f, k, 2 * b) and t.dtype == dtype
            assert t.is_contiguous()


# ------------------------- products against JAX ------------------------- #

CASES = [(g, layout, mode) for mode in NEW_MODES
         for g, layout in (("tiny", "tfpa"), ("dsa10_small", "ftpa"),
                           ("wide", "tfpa"))]


@pytest.mark.parametrize("geom,layout,mode", CASES)
def test_beamform_power_matches_jax(geom, layout, mode):
    jc, pc = _cfgs(geom, mode, input_layout=layout)
    wire = make_random_bytes_block(pc, seed=17)
    qj, qp = _carried_weights(jc)
    want = np.asarray(jgemm.beamform_power(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_power(torch.from_numpy(wire), qp, pc)
    assert tuple(got.shape) == pc.out_block_shape
    _close(got.numpy(), want, mode)


@pytest.mark.parametrize("geom,layout,mode", CASES)
def test_beamform_stokes_matches_jax(geom, layout, mode):
    jc, pc = _cfgs(geom, mode, input_layout=layout)
    wire = make_random_bytes_block(pc, seed=18)
    qj, qp = _carried_weights(jc)
    want = np.asarray(jgemm.beamform_stokes(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_stokes(torch.from_numpy(wire), qp, pc).numpy()
    _close(got, want, mode, peak=np.abs(want[:, :, 0]).max())
    # The I plane is the power product.
    _close(got[:, :, 0], np.asarray(
        jgemm.beamform_power(jnp.asarray(wire), qj, jc)), mode)


@pytest.mark.parametrize("geom,layout,mode", CASES)
def test_beamform_voltages_matches_jax(geom, layout, mode):
    jc, pc = _cfgs(geom, mode, input_layout=layout)
    wire = make_random_bytes_block(pc, seed=19)
    qj, qp = _carried_weights(jc)
    want = np.asarray(jgemm.beamform_voltages(jnp.asarray(wire), qj, jc))
    got = pgemm.beamform_voltages(torch.from_numpy(wire), qp, pc)
    assert tuple(got.shape) == (pc.n_chan, pc.t_block, 2, 2 * pc.n_beams)
    _close(got.numpy(), want, mode)


@pytest.mark.parametrize("stokes", [False, True], ids=["power", "stokes"])
@pytest.mark.parametrize("mode", NEW_MODES)
def test_side_outputs_match_jax(mode, stokes):
    """All side outputs at once: the uint8 product within one count (equal
    for the integer modes' power), incoherent and SK equal."""
    jc, pc = _cfgs("dsa10_small", mode)
    wire = make_random_bytes_block(pc, seed=23)
    qj, qp = _carried_weights(jc)
    jfn = jgemm.beamform_stokes if stokes else jgemm.beamform_power
    pfn = pgemm.beamform_stokes if stokes else pgemm.beamform_power
    f32 = np.asarray(jfn(jnp.asarray(wire), qj, jc))
    plane = f32[:, :, 0] if stokes else f32
    scales = (64.0 / np.median(plane) * np.random.default_rng(3).uniform(
        0.5, 4.0, pc.n_beams)).astype(np.float32)
    kw = dict(incoherent=True, flag_ants=(3,), sk_stats=True)
    want = jfn(jnp.asarray(wire), qj, jc, quant8_scales=jnp.asarray(scales),
               **kw)
    got = pfn(torch.from_numpy(wire), qp, pc, quant8_scales=scales, **kw)
    u8_want, u8_got = np.asarray(want[0]), got[0].numpy()
    assert u8_got.dtype == np.uint8 and u8_got.shape == u8_want.shape
    if mode in INT_MODES and not stokes:
        np.testing.assert_array_equal(u8_got, u8_want)
    else:
        # One count where the float32 products differ in their last bits.
        assert np.abs(u8_got.astype(int) - u8_want.astype(int)).max() <= 1
    assert (u8_got == 255).any() and (u8_got < 255).any()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# ------------------------------- golden --------------------------------- #

@pytest.mark.parametrize("mode,rtol", [
    ("int13", 5e-4), ("int12", 8e-4), ("bf16x2", 2e-4), ("f32", 1e-5),
    ("bf16", 1e-2)])
def test_noise_vs_golden(mode, rtol):
    """The JAX package's accuracy budget per mode (its tests/test_gemm.py)."""
    pc = pcfg.TINY.replace(weight_mode=mode)
    cal = CalTable.random(pc, seed=11)
    wire = make_noise_block(pc, rms=2.5, seed=21)
    p = pgemm.beamform_power(wire, pq.prepare_weights(
        pc, make_weights(pc, cal=cal, device="cpu")), pc).numpy()
    ref = beamform_block_ref(weights_numpy_golden(pc, cal=cal), wire,
                             pc.input_layout, pc.navg_time)
    assert_power_close(p, ref, rtol=rtol, what=mode)


def test_ant_slicing_exact():
    """Dropping zero-padded antennas from K is bit-exact in f32 mode: the
    sliced rows contribute only structural zeros."""
    full = pcfg.TINY.replace(weight_mode="f32")
    sliced = full.replace(n_ant_compute=8)
    wire = make_noise_block(full, rms=2.0, seed=71)
    w = make_weights(full, device="cpu")
    p_full = pgemm.beamform_power(wire, pq.quantize_weights(w, "f32", 16), full)
    p_sl = pgemm.beamform_power(wire, pq.quantize_weights(w, "f32", 8), sliced)
    assert torch.equal(p_full, p_sl)


@pytest.mark.parametrize("mode", INT_MODES)
def test_folded_operand_equals_combined_subterms(mode):
    """The plain version multiplies the JAX operand [16X | X] by the one
    term; the CUDA kernels multiply X by each sub-term and combine
    ``M_hi * 16 + M_lo``.  The same integer."""
    _, pc = _cfgs("tiny", mode)
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(pc, seed=2), pc)
    re, im = pgemm._unpack_chunk(x, pc, tm, 0, pc.n_chan)
    folded = pgemm._gemm_chunk(re, im, qw.terms, 0, pc.n_chan, mode)
    hi, lo = pq.fold_sum(qw.terms[0].to(torch.int32),
                         pq.FOLDED_SUBTERMS[mode])
    xk = torch.cat([re, im], dim=-1).permute(0, 2, 1, 3).reshape(
        pc.n_chan, 2 * pc.t_block, -1)
    combined = torch.matmul(xk, hi) * 16 + torch.matmul(xk, lo)
    assert torch.equal(folded, combined.to(torch.float32))


# ------------------------------- streams -------------------------------- #

class _Collect:
    def __init__(self):
        self.blocks = []

    def write(self, seq, block):
        self.blocks.append((seq, np.array(block)))


@pytest.mark.parametrize("mode", ["int12", "bf16x2"])
def test_stream_matches_jax_pipeline_with_excision(mode):
    """StreamingBeamformer block for block against the JAX pipeline, with an
    RFI monitor that excises a carrier channel mid-stream (the weights are
    re-quantized in the configured mode).  Both sides start from the JAX
    package's float32 steering weights (the two ``make_weights`` agree to
    1e-6, not to the bit), so the terms are the same bytes throughout:
    int12 blocks are equal to the bit, bf16x2 blocks within FLOAT_ATOL."""
    jc, pc = _cfgs("dsa10_small", mode)
    blocks = [make_random_bytes_block(pc, seed=s) for s in (1, 2)]
    for b in blocks:
        b[:, 5, :, :pc.n_ant_active] = 0x77  # a carrier: SK = 0
    jw = jmake_weights(jc)
    pw = CVec(re=torch.from_numpy(np.array(jw.re)),
              im=torch.from_numpy(np.array(jw.im)))
    outs, events = {}, {}
    for name in ("jax", "port"):
        sink, ev = _Collect(), []
        if name == "jax":
            qw = jq.prepare_weights(jc, jw)
            bf = jpipe.StreamingBeamformer(
                jc, qw, jpipe.SyntheticSource(jc, blocks, 6), sink)

            def excise(e, bf=bf, ev=ev):
                ev.append(e)
                if e["type"] == "excise" and not e.get("final"):
                    bf.update_weights(jq.prepare_weights(jc, jzap_weights(
                        jw, e["zapped"], jc)))

            bf.rfi_monitor = JMonitor(jc, interval=2, sample=2,
                                      on_event=excise)
        else:
            qw = pq.prepare_weights(pc, pw)
            bf = ppipe.StreamingBeamformer(
                pc, qw, ppipe.SyntheticSource(pc, blocks, 6), sink)

            def excise(e, bf=bf, ev=ev):
                ev.append(e)
                if e["type"] == "excise" and not e.get("final"):
                    bf.update_weights(pq.prepare_weights(pc, zap_weights(
                        pw, e["zapped"], pc)))

            bf.rfi_monitor = RFIMonitor(pc, interval=2, sample=2,
                                        on_event=excise)
        stats = bf.run()
        assert stats.n_blocks == 6 and stats.dropped == 0
        assert stats.macs == 6 * pc.macs_per_block * pc.n_weight_terms
        outs[name], events[name] = sink.blocks, ev
    assert [e.get("new") for e in events["port"]] \
        == [e.get("new") for e in events["jax"]] == [[5]]
    assert len(outs["port"]) == len(outs["jax"]) == 6
    for (sj, bj), (sp, bp) in zip(outs["jax"], outs["port"]):
        assert sj == sp
        _close(bp, bj, mode)
    assert not outs["port"][-1][1][5].any()       # the carrier is excised
    assert outs["port"][0][1][5].any()


# -------------------- the kernels' path and shared memory ---------------- #

@pytest.mark.parametrize("mode,ac,path", [
    ("int12", 8, "wgmma"), ("int12", 32, "wgmma"),
    ("int12", 40, "wgmma"), ("int12", 128, "wgmma"),
    ("int13", 16, "wgmma"), ("int13", 32, "wgmma"),
    ("int13", 128, "wgmma"), ("int8x2", 32, "wgmma"),
    ("bf16", 8, "wgmma"), ("bf16x2", 128, "wgmma"), ("f32", 32, "wgmma"),
    ("f32", 128, "wgmma"),
])
def test_kernel_path_per_mode(mode, ac, path):
    """One design, the tensor-core one, for every a_compute and every mode;
    a block's shared memory fits an SM's at each; one detect library."""
    cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant_active=8,
                              n_ant_compute=ac)
    assert pgemm.kernel_path(cfg) == path == pgemm.DETECT_MMA
    for stokes in (False, True):
        need, limit = pgemm._detect_smem(cfg, stokes)
        assert 0 < need <= limit
        tiles = pgemm._detect_tiles(cfg, stokes)
        assert tiles.rows >= 1 and tiles.beams in (32, 64)
    assert pgemm.kernel_library(cfg, "detect_power") == "detect_power"


#: The widest n_ant_compute (a multiple of 8) whose whole weight tile the
#: kernels stage at navg_time 16, beside one output row; past it they walk K
#: in slices.
WIDEST = {"int8": 1152, "int8x2": 704, "int12": 704, "int13": 384,
          "bf16": 704, "bf16x2": 392, "f32": 272}


@pytest.mark.parametrize("mode", sorted(pq.TERM_DTYPES))
def test_kernel_path_rejects_other_widths(mode):
    """Every a_compute the JAX package runs is taken, and none is refused:
    DSA-10's wire in auto mode (10, 12 and 20 slots: no multiple of 8, rows
    that start off 4 bytes), 24 and 112, and past the DSA-110 width 136,
    160, 224 and the widest whose weight tile fits beside a row take the
    staged tile (``"wgmma"``); past that edge, at 2048 and past 2048 (the
    shared-memory copy of the incoherent mask's words) the K loop
    (``"wgmma-kloop"``), whose slices fit in a block's shared memory
    whatever the width."""
    for n in (10, 12, 20):
        cfg = pcfg.TINY.replace(weight_mode=mode, n_ant=n,
                                n_ant_active=min(n, 10))
        # int13 rounds 10 active antennas up to 16 (JAX config.a_compute).
        assert cfg.a_compute == (16 if mode == "int13" and n == 20 else n)
        assert pgemm.kernel_path(cfg) == "wgmma"
    for ac in (24, 112, 136, 160, 224, WIDEST[mode]):
        cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant=max(ac, 160),
                                  n_ant_active=8, n_ant_compute=ac)
        assert pgemm.kernel_path(cfg) == "wgmma"
    limit = 227 * 1024 - 256
    for ac in (WIDEST[mode] + 8, 2048, 2056):
        cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant=ac, n_ant_active=8,
                                  n_ant_compute=ac)
        assert pgemm.kernel_path(cfg) == pgemm.KLOOP_MMA == "wgmma-kloop"
        for stokes in (False, True):
            tiles = pgemm._detect_tiles(cfg, stokes)
            assert tiles.slices >= 2 and tiles.smem <= limit
        assert pgemm._voltage_tiles(cfg).smem <= limit


def test_detect_smem_follows_the_kernels_layouts():
    """The weight tile, warpgroups, span rows and bytes one block stages
    (csrc: make_mma_geom, fit_spans)."""
    wide = pcfg.DSA110.replace(n_ant_compute=128)
    limit = 227 * 1024 - 256          # less the static copy of the mask
    # int8 modes, a_compute 128: a 64-beam tile is 128 columns x sub-terms x
    # 256 K bytes; an output row's wire bytes are 16 samples x 2 pols x 144
    # (128 padded to nine 16-byte units), in two buffers; each warpgroup
    # keeps its SK partial sums (2 x 128 int32).  Four warpgroups with a
    # span of four rows each fit beside two sub-terms, two beside int13's
    # four.
    row = 2 * 16 * 2 * 144
    sk = 8 * 128
    assert pgemm._detect_tiles(wide.replace(weight_mode="int12")) \
        == (64, 4, 4, 2 * 32768 + 4 * (4 * row + sk), 0)
    assert pgemm._detect_smem(wide.replace(weight_mode="int12")) \
        == (2 * 32768 + 4 * (4 * row + sk), limit)
    assert pgemm._detect_tiles(wide.replace(weight_mode="int13")) \
        == (64, 2, 4, 4 * 32768 + 2 * (4 * row + sk), 0)
    # Stokes: two warpgroups (the running sums take the registers), so a
    # span of eight rows each.
    assert pgemm._detect_tiles(wide.replace(weight_mode="int12"), True) \
        == (64, 2, 8, 2 * 32768 + 2 * (8 * row + sk), 0)
    # dsa10 (a_compute 32: 48-byte rows): four warpgroups, 16-row spans.
    assert pgemm._detect_tiles(pcfg.DSA10) \
        == (64, 4, 16, 128 * 128 + 4 * (16 * 2 * 16 * 2 * 48 + 8 * 32), 0)
    # One round of output rows: one warpgroup.
    assert pgemm._detect_tiles(pcfg.TINY.replace(t_block=64))[1:3] == (1, 4)
    # bf16 at a_compute 128: k16 steps of 8 antennas, 16 a term of 32 bytes
    # a column, so a term is 64 KB of a 64-beam tile, as an int8 sub-term.
    assert pgemm._detect_tiles(wide.replace(weight_mode="bf16")) \
        == (64, 4, 4, 65536 + 4 * (4 * row + sk), 0)
    # bf16x2, dsa10: two terms of 4 k16 steps, 32 KB; four warpgroups of
    # sixteen rows fit beside them.
    d10 = pcfg.DSA10.replace(weight_mode="bf16x2")
    assert pgemm._detect_tiles(d10) \
        == (64, 4, 16, 32768 + 4 * (16 * 2 * 16 * 2 * 48 + 8 * 32), 0)
    # f32 at a_compute 128: three bf16 parts of 64 KB leave a 64-beam tile
    # room for one warpgroup of three rows, so the tile is 32 beams: three
    # warpgroups of four rows (Stokes: the two it may have).
    f32 = wide.replace(weight_mode="f32")
    assert pgemm.n_subterms(f32) == pgemm.F32_PARTS == 3
    assert pgemm._detect_tiles(f32) \
        == (32, 3, 4, 98304 + 3 * (4 * row + sk), 0)
    assert pgemm._detect_tiles(f32, True) \
        == (32, 2, 4, 98304 + 2 * (4 * row + sk), 0)
    # At a_compute 112 (seven 16-byte units a row) the 64-beam tile leaves
    # room for two warpgroups of four rows, and is kept.
    f112 = f32.replace(n_ant_compute=112)
    assert pgemm._detect_tiles(f112) \
        == (64, 2, 4, 172032 + 2 * (4 * 7168 + 8 * 112), 0)
    # bf16x2 at a_compute 128 keeps the 64-beam tile: two warpgroups fit.
    assert pgemm._detect_tiles(wide.replace(weight_mode="bf16x2"))[:2] \
        == (64, 2)
    assert pgemm.n_subterms(wide.replace(weight_mode="int13")) == 4
    assert pgemm.kernel_library(d10, "detect_power") == "detect_power"
    # One voltage library for every mode, as for detection.
    assert pgemm.kernel_library(d10, "beam_voltages") == "beam_voltages"
    assert pgemm.kernel_library(wide.replace(weight_mode="int13"),
                                "beam_voltages") == "beam_voltages"
    # A navg_time whose rows do not fit beside the weight tile takes the K
    # loop, which stages one m-tile (8 samples) a warp whatever navg is.
    for mode in ("bf16x2", "int8x2"):
        long_rows = wide.replace(weight_mode=mode, t_block=4096,
                                 navg_time=512)
        need, limit = pgemm._detect_smem(long_rows)
        assert need <= limit
        assert pgemm.kernel_path(long_rows) == pgemm.KLOOP_MMA
    assert pgemm._detect_tiles(
        wide.replace(t_block=4096, navg_time=512)).rows == 4


def test_kloop_tiles_follow_the_kernels_layouts():
    """The K loop's block (csrc make_sliced_geom): one warpgroup, spans of
    one round (4 output rows, or the voltage kernel's 4 m-tiles), two
    buffers each of a 64-beam slice of 256 K bytes a column (one sub-term:
    128 antennas of int8 k32 steps, 64 of bf16 k16 steps) and of 32 wire
    rows a pol (the slice's antennas padded to an odd number of 16-byte
    units: 144 bytes int8, 80 bf16), the voltage kernel's restaged rows (16
    a warp, 68 floats: 17,408 bytes) beside them; ceil(a_compute /
    antennas) slices."""
    for mode, ac, stride, ants in (("int8x2", 712, 144, 128),
                                   ("int13", 2056, 144, 128),
                                   ("f32", 280, 80, 64),
                                   ("bf16x2", 2048, 80, 64)):
        cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant=ac, n_ant_active=8,
                                  n_ant_compute=ac)
        smem = 2 * (2 * 64 * 256 + 2 * 32 * stride)
        slices = -(-ac // ants)
        for stokes in (False, True):
            assert pgemm._detect_tiles(cfg, stokes) \
                == (64, 1, 4, smem, slices)
        if ac >= 2048:
            assert pgemm._voltage_tiles(cfg) \
                == (64, 1, 4, 32, smem + 4 * 16 * 68 * 4, slices)
    # Fewer output rows than a round: a span of what there is.
    tiny_rows = pcfg.DSA110.replace(n_ant=2048, n_ant_active=8,
                                    n_ant_compute=2048, t_block=32)
    assert pgemm._detect_tiles(tiny_rows).rows == 2


@pytest.mark.parametrize("mode", sorted(pq.TERM_DTYPES))
def test_slice_layout_follows_the_kernels_descriptor(mode):
    """The K loop's weights in slice order (``_slice_layout``): slice
    ``(channel, beam tile, sub-term, slice)`` holds byte ``k`` of column
    ``c = 2 * beam + (0 Re, 1 Im)`` at csrc w_offset ``(c // 8) * 2048 +
    (k // 16) * 128 + (c % 8) * 16 + k % 16``, where k32 step ``s`` of the
    slice is ``[16 re | 16 im]`` antennas (int8: byte ``32 s + 16 part + j``
    is antenna ``16 s + j``) or k16 step ``[8 re | 8 im]`` bfloat16
    (antenna ``8 s + j`` at bytes ``2 (16 s + 8 part + j)``); zeros past
    a_compute and n_beams; f32 the three parts of ``_split_f32``."""
    cfg = pcfg.TINY.replace(weight_mode=mode, n_ant=136, n_ant_active=130,
                            n_ant_compute=136, n_beams=70, n_chan=2)
    qw = pq.prepare_weights(cfg, make_weights(cfg, device="cpu"))
    got = pgemm._slice_layout(qw.terms, cfg).numpy()
    bf16 = mode in pgemm.FLOAT_MODES
    ants = 64 if bf16 else 128
    a, b = cfg.a_compute, cfg.n_beams
    n_sl, n_bt = -(-a // ants), -(-b // 64)
    if mode == "f32":
        subs = [t.view(torch.int16).numpy()
                for t in pgemm._split_f32(qw.terms[0])]
    elif bf16:
        subs = [t.view(torch.int16).numpy() for t in qw.terms]
    elif mode in pq.FOLDED_SUBTERMS:
        n = pgemm.n_subterms(cfg)
        subs = list(qw.terms[0].numpy().reshape(2, n, 2 * a, 2 * b)
                    .transpose(1, 0, 2, 3))
    else:
        subs = [t.numpy() for t in qw.terms]
    assert got.shape == (2, n_bt, len(subs), n_sl, 2 * 64 * 256)
    want = np.zeros_like(got)
    for t, w in enumerate(subs):
        w = w.view(np.uint8).reshape(2, 2 * a, 2 * b, -1)  # bytes of a weight
        for f in range(2):
            for beam in range(b):
                bt, bl = divmod(beam, 64)
                for ri in range(2):
                    c = 2 * bl + ri
                    for part in range(2):
                        for ant in range(a):
                            sl, al = divmod(ant, ants)
                            if bf16:
                                k0 = 2 * ((al // 8) * 16 + part * 8 + al % 8)
                            else:
                                k0 = (al // 16) * 32 + part * 16 + al % 16
                            for j, byte in enumerate(
                                    w[f, part * a + ant, ri * b + beam]):
                                k = k0 + j
                                at = (c // 8) * 2048 + (k // 16) * 128 \
                                    + (c % 8) * 16 + k % 16
                                want[f, bt, t, sl, at] = byte
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(pq.TERM_DTYPES))
def test_no_staged_tile_past_the_masks_static_copy(mode):
    """Past 32 * MASK_WORDS antennas (the detect kernel's static copy of
    the incoherent mask) not even the 32-beam tile fits in a block beside
    the shortest output row, so the K loop, which reads the mask from a
    device copy, takes every such width (csrc dsabf_detect_power relies on
    it)."""
    for ac in (32 * pgemm.MASK_WORDS + 8, 32 * pgemm.MASK_WORDS + 16, 4096):
        cfg = pcfg.DSA110.replace(weight_mode=mode, n_ant=ac, n_ant_active=8,
                                  n_ant_compute=ac, navg_time=1)
        assert 2 * 32 * pgemm.n_subterms(cfg) * 32 * -(-ac // 16) \
            > pgemm._MMA_DYN_SMEM
        assert pgemm._mma_tiles(cfg, 1, 1, 4, 2, 0).slices > 0
        assert pgemm._detect_tiles(cfg).slices > 0


def test_operand_checks_per_mode():
    """Terms of another dtype or count than the configured mode's are
    refused, on the CPU as before any launch."""
    pc = pcfg.TINY.replace(weight_mode="bf16x2")
    qw = pq.prepare_weights(pc, make_weights(pc, device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(pc), pc)
    pgemm._check_kernel_operands(x, qw.terms, qw.scales, pc, tm)
    with pytest.raises(ValueError, match="takes 2 bfloat16 weight term"):
        pgemm._check_kernel_operands(
            x, tuple(t.float() for t in qw.terms), qw.scales, pc, tm)
    with pytest.raises(ValueError, match="takes 2 bfloat16 weight term"):
        pgemm._check_kernel_operands(
            x, qw.terms[:1], qw.scales[:, :1].contiguous(), pc, tm)
    with pytest.raises(ValueError, match="takes 2 int8 weight term"):
        pgemm.beamform_power(make_random_bytes_block(pc), qw,
                             pc.replace(weight_mode="int8x2"))
    # Both libraries read the terms from (n_terms, fold, element size).
    assert pgemm._operand_args(pc, qw.terms) == [2, 0, 2]
    f32 = pcfg.TINY.replace(weight_mode="f32")
    qf = pq.prepare_weights(f32, make_weights(f32, device="cpu"))
    assert pgemm._operand_args(f32, qf.terms) == [1, 0, 4]
    i13 = pcfg.TINY.replace(weight_mode="int13")
    q13 = pq.prepare_weights(i13, make_weights(i13, device="cpu"))
    assert pgemm._operand_args(i13, q13.terms) == [4, 1, 1]
    assert pgemm._operand_args(pcfg.TINY, (q13.terms[0],) * 2) == [2, 0, 1]
    assert pgemm._operand_args(pcfg.TINY.replace(weight_mode="int12"),
                               q13.terms) == [2, 1, 1]


# -------------------------- tables carried across ------------------------ #

@pytest.mark.parametrize("mode", NEW_MODES)
def test_weight_tables_cross_the_packages(mode, tmp_path):
    """A table saved by either package loads in the port with the same bits
    (bfloat16 as two-byte records); the port's loads in the JAX package too,
    except in the bfloat16 modes, where the JAX package cannot load even its
    own table."""
    jc, pc = _cfgs("dsa10_small", mode)
    qj, qp = _carried_weights(jc)
    for a, b in zip(qj.terms, qp.terms):
        assert b.dtype == pq.TERM_DTYPES[mode] and b.is_contiguous()
        np.testing.assert_array_equal(
            pq._term_to_numpy(b).view(np.uint8),
            np.ascontiguousarray(np.asarray(a)).view(np.uint8))
    jq.save_quant_weights(str(tmp_path / "jax.npz"), qj)
    pq.save_quant_weights(str(tmp_path / "port.npz"), qp)
    with np.load(tmp_path / "jax.npz") as dj, \
            np.load(tmp_path / "port.npz") as dp:
        assert sorted(dj.files) == sorted(dp.files)
        for k in dj.files:
            assert dj[k].dtype == dp[k].dtype
            assert dj[k].tobytes() == dp[k].tobytes()
    for name in ("jax.npz", "port.npz"):
        back = pq.load_quant_weights(str(tmp_path / name), device="cpu")
        for a, b in zip(qp.terms, back.terms):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(back.scales, qp.scales)
    if mode.startswith("bf16"):
        with pytest.raises(TypeError):
            jq.load_quant_weights(str(tmp_path / "jax.npz"))
    else:
        from_port = jq.load_quant_weights(str(tmp_path / "port.npz"))
        for a, b in zip(qj.terms, from_port.terms):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_bfloat16_bits_carried_from_uint16():
    bits = np.array([[[0x3F80, 0xBF80], [0x4000, 0x0000]]], np.uint16)
    for given in (bits, bits.view("V2")):
        qw = pq.quant_weights_from_numpy([given], np.ones((1, 1), np.float32),
                                         device="cpu")
        assert qw.terms[0].dtype == torch.bfloat16
        assert qw.terms[0].float().tolist() == [[[1.0, -1.0], [2.0, 0.0]]]
