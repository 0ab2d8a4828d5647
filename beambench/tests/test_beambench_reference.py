"""The reference against a brute-force float64 beamform at tiny shapes."""

import itertools

import numpy as np
import torch

from beambench import inputs
from beambench.reference import beamform as ref


def _nibble(x: int) -> int:
    return x - 16 if x >= 8 else x


def test_unpack_every_byte():
    b = torch.arange(256, dtype=torch.int64).to(torch.uint8)
    re, im = ref.unpack(b)
    assert re.tolist() == [_nibble(v >> 4) for v in range(256)]
    assert im.tolist() == [_nibble(v & 0xF) for v in range(256)]


def _brute(obs, w, wire):
    """Loops over every (f, t, p, b, a): power, incoherent and SK."""
    t_all, f_all, n_p, _ = wire.shape  # tfpa
    n_act, nt = obs["n_ant_active"], obs["navg_time"]
    n_b = w.shape[1]
    power = np.zeros((f_all, t_all // nt, n_b))
    inco = np.zeros((f_all, t_all // nt))
    sk = np.zeros((f_all, 2))
    for f, t, p in itertools.product(range(f_all), range(t_all), range(n_p)):
        v = [complex(_nibble(int(x) >> 4), _nibble(int(x) & 0xF))
             for x in wire[t, f, p, :n_act]]
        for b in range(n_b):
            beam = sum(w[f, b, a] * v[a] for a in range(n_act))
            power[f, t // nt, b] += abs(beam) ** 2
        for a in range(n_act):
            pw = abs(v[a]) ** 2
            inco[f, t // nt] += pw
            sk[f, 0] += pw
            sk[f, 1] += pw * pw
    return power, inco, sk


def test_products_equal_brute_force(tiny):
    obs = dict(tiny["obs"], n_chan=3, n_chan_total=3, t_block=32, n_beams=5)
    spec = dict(tiny, obs=obs)
    wire = inputs.wire_block(spec, 11, 0, "cpu")
    w = inputs.steering_weights(spec, 11, "cpu")
    got = ref.products(obs, w, wire)
    want = _brute(obs, w.numpy(), wire.numpy())
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.numpy(), x, rtol=1e-12, atol=1e-9)


def test_products_in_channel_chunks_equal_one_chunk(tiny, monkeypatch):
    obs = tiny["obs"]
    wire = inputs.wire_block(tiny, 3, 1, "cpu")
    w = inputs.steering_weights(tiny, 3, "cpu")
    whole = ref.products(obs, w, wire)
    per_chan = obs["t_block"] * obs["n_pol"] * obs["n_beams"] * 16
    monkeypatch.setattr(ref, "_BUDGET", 3 * per_chan)
    for a, b in zip(whole, ref.products(obs, w, wire)):
        assert torch.equal(a, b)


def test_quant8_scales_put_each_median_at_64():
    p = torch.tensor([[[1.0, 4.0]], [[3.0, 0.0]], [[2.0, 0.0]],
                      [[5.0, 0.0]]], dtype=torch.float64)  # [4, 1, 2]
    s = ref.quant8_scales(p)
    assert s.tolist() == [64.0 / 2.5, 1.0]


def test_inputs_repeat_from_the_seed_and_differ_between_blocks(tiny):
    a = inputs.wire_block(tiny, 2**31 + 5, 0, "cpu")
    assert torch.equal(a, inputs.wire_block(tiny, 2**31 + 5, 0, "cpu"))
    assert not torch.equal(a, inputs.wire_block(tiny, 2**31 + 5, 1, "cpu"))
    assert not torch.equal(a, inputs.wire_block(tiny, 2**31 + 6, 0, "cpu"))
    assert int(a[..., tiny["obs"]["n_ant_active"]:].count_nonzero()) == 0
    w = inputs.steering_weights(tiny, 9, "cpu")
    assert torch.allclose(w.abs(), torch.ones_like(w.abs()))
