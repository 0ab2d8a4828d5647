"""The port's copies of the JAX package's NumPy-only definitions (config
geometry, tolerance metric) held equal to the originals, plus the port's
device-utilization accounting."""

import dataclasses

import numpy as np
import pytest

import dsabeamformer_tpu.config as jcfg
import dsabeamformer_tpu.utils.testing as jtesting
import dsabeamformer_tpu_torch.config as pcfg
import dsabeamformer_tpu_torch.utils.testing as ptesting
from dsabeamformer_tpu_torch.utils.metrics import (
    StreamStats,
    peak_macs_per_s,
    tensor_core_utilization,
)

DERIVED = ("sample_period_s", "block_duration_s", "wire_block_shape",
           "wire_block_bytes", "device_wire_shape", "out_block_shape",
           "realtime_bytes_per_s", "a_compute", "gemm_k", "macs_per_block",
           "n_weight_terms")


def _pairs():
    jp, pp = jcfg.presets(), pcfg.presets()
    assert sorted(jp) == sorted(pp)
    out = [(jp[k], pp[k]) for k in sorted(jp)]
    for mode in ("int13", "int12", "int8"):
        out.append((jcfg.DSA10.replace(weight_mode=mode),
                    pcfg.DSA10.replace(weight_mode=mode)))
    out.append((jcfg.TINY.replace(input_layout="ftpa", n_ant_compute=8),
                pcfg.TINY.replace(input_layout="ftpa", n_ant_compute=8)))
    return out


@pytest.mark.parametrize("pair", _pairs(), ids=lambda p: p[0].name)
def test_config_matches_jax(pair):
    j, p = pair
    for f in dataclasses.fields(p):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    port_only = {f.name for f in dataclasses.fields(p)} - {
        f.name for f in dataclasses.fields(j)}
    assert not port_only
    for name in DERIVED:
        assert getattr(p, name) == getattr(j, name), name
    np.testing.assert_array_equal(p.freqs_hz(), j.freqs_hz())
    np.testing.assert_array_equal(p.beam_angles_rad(), j.beam_angles_rad())
    sj, sp = j.subband(16, 8), p.subband(16, 8)
    assert (sp.n_chan, sp.f_start_hz) == (sj.n_chan, sj.f_start_hz)


@pytest.mark.parametrize("bad", [
    {"n_pol": 1},
    {"n_ant_active": 20},
    {"navg_freq": 3},
    {"weight_mode": "int4"},
    {"input_layout": "pfta"},
    {"n_ant_compute": 12},
    {"n_ant_compute": 24},
])
def test_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as ej:
        jcfg.TINY.replace(**bad)
    with pytest.raises(ValueError) as ep:
        pcfg.TINY.replace(**bad)
    assert str(ep.value) == str(ej.value)


def test_config_rejects_unaveraged_block():
    with pytest.raises(ValueError, match="multiple of navg_time"):
        pcfg.TINY.replace(t_block=40)


@pytest.mark.parametrize("seed", range(4))
def test_relative_power_error_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref = rng.random((4, 5, 6)) * 10.0 ** seed
    p = ref * (1 + 1e-4 * rng.standard_normal(ref.shape))
    if seed == 3:
        ref = np.zeros_like(ref)
    assert ptesting.relative_power_error(p, ref) == \
        jtesting.relative_power_error(p, ref)
    with pytest.raises(ValueError, match="shape mismatch"):
        ptesting.relative_power_error(p, ref[:1])


@pytest.mark.parametrize("kind,tops", [
    ("NVIDIA H100 80GB HBM3", 1979e12),
    ("NVIDIA H100 PCIe", 1513e12),
    ("NVIDIA H100 NVL", 1670.5e12),
    ("NVIDIA H200", 1979e12),
    ("cpu", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_table(kind, tops):
    got = peak_macs_per_s(kind, "int8")
    assert got == (None if tops is None else tops / 2)


@pytest.mark.parametrize("mode,macs_per_s", [
    ("int8", 989.5e12), ("int8x2", 989.5e12), ("int12", 989.5e12),
    ("int13", 989.5e12), ("bf16", 494.5e12), ("bf16x2", 494.5e12),
    ("f32", None),
])
def test_peak_follows_the_operand_type(mode, macs_per_s):
    """The utilization is booked against the dense peak for the mode's
    operand type (the JAX package: int8 or bf16); f32 runs outside the
    tensor cores and has none."""
    kind = "NVIDIA H100 80GB HBM3"
    assert peak_macs_per_s(kind, mode) == macs_per_s
    assert peak_macs_per_s("cpu", mode) is None
    cfg = pcfg.DSA10.replace(weight_mode=mode)
    macs = cfg.macs_per_block * cfg.n_weight_terms
    u = tensor_core_utilization(macs, 2.0, cfg, kind)
    rec = StreamStats(cfg_name="dsa10", device_kind=kind, n_blocks=1,
                      macs=macs).finish().record(cfg)
    if macs_per_s is None:
        assert u is None and rec["tc_utilization_issued"] is None
    else:
        assert u["issued"] == pytest.approx(macs / 2.0 / macs_per_s)
        assert u["padded_k"] == pytest.approx(
            u["issued"] * cfg.n_ant / cfg.a_compute)
        assert rec["tc_utilization_issued"] > 0


def test_utilization_accounting():
    cfg = pcfg.DSA10
    macs = cfg.macs_per_block * cfg.n_weight_terms
    u = tensor_core_utilization(macs, 1.0, cfg, "NVIDIA H100 80GB HBM3")
    assert u["issued"] == pytest.approx(macs / 989.5e12)
    assert u["padded_k"] == pytest.approx(2 * u["issued"])  # 64 / 32
    assert tensor_core_utilization(macs, 1.0, cfg, "cpu") is None
    assert tensor_core_utilization(macs, 0.0, cfg, "NVIDIA H100 PCIe") is None
    rec = StreamStats(cfg_name="dsa10", n_blocks=2, bytes_in=10,
                      macs=macs).finish().record(cfg)
    assert rec["device"] == "cpu" and rec["tc_utilization_issued"] is None
    assert rec["realtime_factor"] > 0


def test_peak_macs_env_override_as_jax(monkeypatch):
    """``DSABF_PEAK_INT8_MACS`` / ``DSABF_PEAK_BF16_MACS`` override the table
    for their operand type, as in the JAX package's ``peak_macs_per_s``."""
    from dsabeamformer_tpu.utils import metrics as jmetrics

    kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setenv("DSABF_PEAK_INT8_MACS", "1.5e14")
    assert jmetrics.peak_macs_per_s(True) == 1.5e14
    for mode in ("int8", "int8x2", "int12", "int13"):
        assert peak_macs_per_s(kind, mode) == 1.5e14
        assert peak_macs_per_s("cpu", mode) == 1.5e14   # an unknown device
    assert peak_macs_per_s(kind, "bf16") == 494.5e12     # not its operand
    monkeypatch.setenv("DSABF_PEAK_BF16_MACS", "7.5e13")
    assert jmetrics.peak_macs_per_s(False) == 7.5e13
    assert peak_macs_per_s(kind, "bf16x2") == 7.5e13
    assert peak_macs_per_s("cpu", "f32") is None         # no tensor-core path
    cfg = pcfg.DSA10
    macs = cfg.macs_per_block * cfg.n_weight_terms
    u = tensor_core_utilization(macs, 1.0, cfg, "cpu")
    assert u["issued"] == pytest.approx(macs / 1.5e14)
    monkeypatch.delenv("DSABF_PEAK_INT8_MACS")
    assert peak_macs_per_s(kind, "int8") == 989.5e12
