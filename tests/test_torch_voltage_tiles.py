"""The voltage kernel's design, checked on the CPU (its PTX has no host
form): the tile it takes (``_voltage_tiles``, the C arithmetic of
``csrc/mma_gemm.cuh`` make_mma_geom), where it stores each accumulator
(``_voltage_store_map``), and its epilogue applied to the tensor-core
products stated in torch (``_mma_product``, ``_bf16_product``) against the
plain version ``voltages_plain``, which the JAX package's
``beamform_voltages`` is held to in ``tests/test_torch_voltages.py``."""

import numpy as np
import pytest
import torch

import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.ops.gemm as pgemm
import dsabeamformer_tpu_torch.ops.quantize as pq
from dsabeamformer_tpu_torch.ingest.generator import make_random_bytes_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights

A_COMPUTES = range(8, pgemm.MAX_A_COMPUTE + 1, 8)
BEAMS = (40, 72, 100, 256, 512)
INT_MODES = ("int8", "int8x2", "int12", "int13")


def _cfg(mode, ac, **kw):
    """A DSA-110 slice contracting exactly ``ac`` antennas in ``mode``."""
    base = dict(weight_mode=mode, n_ant=128, n_ant_active=ac - 2,
                n_ant_compute=ac, n_chan=2, t_block=4096)
    base.update(kw)
    return pcfg.DSA110.replace(**base)


@pytest.mark.parametrize("ac", A_COMPUTES)
@pytest.mark.parametrize("mode", pgemm.KERNEL_MODES)
def test_voltage_tiles_fit_and_narrow_where_the_c_rule_does(mode, ac):
    """Every mode at every a_compute the kernel takes, for every beam count:
    the block's shared memory (weight tile, two wire buffers and 16
    restaged rows of the tile's width a warp, per warpgroup) is within the
    limit, a span is a whole number of m-tiles, and the tile is 32 beams
    exactly where a bf16 tile of 64 would leave room for fewer than three
    warpgroups of four m-tiles (bf16x2 from a_compute 120, f32 from 88)."""
    bf16 = mode in pgemm.FLOAT_MODES
    n_steps = ac // 8 if bf16 else -(-ac // 16)
    k_total = pgemm.n_subterms(_cfg(mode, ac)) * 32 * n_steps
    raw_stride = 16 * (-(-ac // 16) | 1)
    m_tile_bytes = 2 * 8 * 2 * raw_stride           # both wire buffers

    def group_bytes(beams, rows):
        return rows * m_tile_bytes + 4 * 16 * (beams + 4) * 4

    wide_three = 2 * 64 * k_total + 3 * group_bytes(64, 4)
    narrow = bf16 and wide_three > pgemm._MMA_DYN_SMEM
    assert narrow == ((mode == "bf16x2" and ac >= 120)
                      or (mode == "f32" and ac >= 88))
    for b in BEAMS:
        cfg = _cfg(mode, ac, n_beams=b)
        assert cfg.a_compute == ac
        t = pgemm._voltage_tiles(cfg)
        assert t.beams == (32 if narrow else 64), (b, t)
        assert 1 <= t.groups <= 4 and t.rows >= 1
        assert t.rows <= 4 or t.rows % 4 == 0
        assert t.samples == 8 * t.rows
        assert t.smem == 2 * t.beams * k_total \
            + t.groups * group_bytes(t.beams, t.rows)
        assert t.smem <= pgemm._MMA_DYN_SMEM
    # The int8 modes keep the 64-beam tile, with two warpgroups or more up
    # to a_compute 112 (int13's four sub-terms at 120 and 128: one).
    if not bf16 and not (mode == "int13" and ac > 112):
        assert pgemm._voltage_tiles(_cfg(mode, ac)).groups >= 2


#: (mode, a_compute, t_block, navg_time, n_beams, n_chan): a tail of t_block
#: that is no multiple of 8 (the last m-tile half live), beam counts that are
#: no multiple of the tile (or of 4), the DSA-110 width, several spans and
#: shares of the grid's z axis.
MAP_CASES = [
    ("int8x2", 32, 36, 4, 72, 2),
    ("int8x2", 32, 1000, 8, 100, 1),
    ("int13", 16, 44, 4, 40, 3),
    ("int12", 128, 260, 4, 512, 2),
    ("bf16x2", 128, 100, 4, 130, 2),
    ("f32", 112, 68, 4, 33, 2),
    ("bf16", 24, 12, 4, 256, 1),
    ("int8", 8, 4, 4, 3, 1),
]


@pytest.mark.parametrize("case", MAP_CASES, ids=lambda c: "-".join(map(str, c)))
def test_voltage_store_map_covers_every_element_once(case):
    """The kernel's store map covers every element of a channel's ``[T, P,
    2B]`` exactly once, and each from the register that holds it: Re of
    beam b in column b, Im in column B + b, of its own sample and pol."""
    mode, ac, t_block, navg, b, n_chan = case
    cfg = _cfg(mode, ac, t_block=t_block, navg_time=navg, n_beams=b,
               n_chan=n_chan)
    (ts, ps, beam, ri), (t, p, col) = pgemm._voltage_store_map(cfg)
    idx = (t * 2 + p) * 2 * b + col
    counts = torch.bincount(idx, minlength=t_block * 2 * 2 * b)
    assert counts.numel() == t_block * 2 * 2 * b
    assert bool((counts == 1).all())
    assert int(t.max()) == t_block - 1 and int(col.max()) == 2 * b - 1
    assert torch.equal(ts, t) and torch.equal(ps, p)
    assert torch.equal(ri * b + beam, col)


def _operands(mode, ac, layout, seed):
    cfg = _cfg(mode, ac, n_chan=2, t_block=36, navg_time=4, n_beams=72,
               input_layout=layout)
    qw = pq.prepare_weights(cfg, make_weights(
        cfg, cal=CalTable.random(cfg, seed=seed), device="cpu"))
    x, tm = pgemm._prepare_wire(make_random_bytes_block(cfg, seed=ac), cfg)
    return cfg, qw, x, tm


def _scatter(cfg, values_of):
    """The kernel's output: the accumulator values ``values_of(t, p, beam,
    ri)`` of each register, put where ``_voltage_store_map`` says the
    kernel stores that register."""
    src, (t, p, col) = pgemm._voltage_store_map(cfg)
    b = cfg.n_beams
    out = torch.full((cfg.n_chan, cfg.t_block, 2, 2 * b), float("nan"))
    out[:, t, p, col] = values_of(*src)
    return out


@pytest.mark.parametrize("layout", ["tfpa", "ftpa"])
@pytest.mark.parametrize("ac", [8, 24, 32, 40, 112, 128])
@pytest.mark.parametrize("mode", pgemm.KERNEL_MODES)
def test_store_map_of_the_products_gives_the_plain_voltages(mode, ac,
                                                            layout):
    """The tensor-core products stated in torch, put through the kernel's
    epilogue and store map: the int8 modes' accumulators (``_mma_product``
    times the product scale, 16 for int8 and int8x2) to float32, times
    ``1 / 16`` and the channel's scale, equal ``voltages_plain`` bit for
    bit; the bf16 operands' sums (``_bf16_product``) rounded to float32
    are within 1e-5 of the largest voltage (the kernel's float32 sums run
    in another order than the plain version's GEMM).  t_block 36 (a half
    m-tile at the end), 72 beams (a partial tile)."""
    cfg, qw, x, tm = _operands(mode, ac, layout, seed=4)
    want = pgemm.voltages_plain(x, qw.terms, qw.scales, cfg, tm)
    s = qw.scales[:, -1].view(-1, 1)
    if mode in INT_MODES:
        re, im = pgemm._unpack_chunk(x, cfg, tm, 0, cfg.n_chan)
        ps = 1 if mode in pq.FOLDED_SUBTERMS else 16
        acc = pgemm._mma_product(*pgemm._mma_operands(re, im, qw.terms, cfg),
                                 cfg) * ps
        assert int(acc.abs().max()) < 2 ** 31
        got = _scatter(cfg, lambda t, p, b, ri: pgemm._voltage_value(
            acc[:, t, p, b, ri], ps, s))
        assert torch.equal(got, want)
    else:
        wire = pgemm._wire_chunk(x, cfg, tm, 0, cfg.n_chan)
        v = pgemm._bf16_product(*pgemm._bf16_operands(wire, qw.terms, cfg))
        got = _scatter(cfg, lambda t, p, b, ri: pgemm._voltage_value(
            v[:, t, p, b, ri], 1, s))
        assert not bool(got.isnan().any())
        assert float((got - want).abs().max()) \
            <= 1e-5 * float(want.abs().max())
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("kind", ["below_2_24", "past_2_24", "edges"])
def test_product_scale_divides_out_exactly(kind):
    """float32(16 M) * 2^-4 * s == float32(M) * s for |M| < 2^27, with each
    multiply rounded once: the unfolded int8 modes' epilogue gives the
    plain version's voltage to the bit, also where float32(M) rounds."""
    rng = np.random.default_rng({"below_2_24": 1, "past_2_24": 2,
                                 "edges": 3}[kind])
    if kind == "below_2_24":
        m = rng.integers(-2 ** 24, 2 ** 24, 200_000)
    elif kind == "past_2_24":
        m = rng.integers(2 ** 24, 2 ** 27, 200_000) \
            * rng.choice([-1, 1], 200_000)
    else:
        edge = np.array([0, 1, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, 2 ** 25 + 3,
                         2 ** 27 - 1, 2 ** 27 - 3, 2 ** 26 + 5])
        m = np.concatenate([edge, -edge])
    m = torch.from_numpy(m.astype(np.int64))
    s = torch.from_numpy(rng.uniform(1e-4, 4.0, m.numel()).astype(np.float32))
    acc = (16 * m).to(torch.int32)
    got = pgemm._voltage_value(acc, 16, s)
    want = m.to(torch.float32) * s
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kind == "past_2_24":
        assert bool((m.to(torch.float32).to(torch.int64) != m).any())
