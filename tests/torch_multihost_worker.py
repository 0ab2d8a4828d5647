"""One process of an n-process deployment of the port (spawned by
tests/test_torch_multihost.py and tests/test_torch_cuda.py).

Runs the port's multi-process path (``parallel/multihost.py``):
``initialize_multihost`` -> ``my_subband`` -> this process's subband of a
seeded full-band block -> its own mesh of ``--slots`` slots on ``--device``,
and writes what it computed to ``<out>/proc<rank>.npz`` (and refusals to
``<out>/proc<rank>.json``) for the parent to hold against the JAX package
(CPU) or the single-device kernel (card).  Imports only the port.

Modes (``--mode``, several joined by ``+``):

- ``step``: one ``sharded_beamformer`` step on the subband with band power,
  the band ``all_reduce``d over the processes: ``step_out``,
  ``step_band``.
- ``stream``: 8 blocks through ``MultihostMeshStreamingBeamformer`` with
  band power and a weight update at the drain of block 2:
  ``stream_seq``, ``stream_out``, ``stream_band``.
- ``refuse``: the multihost stream's refusals: a world size that does not divide the
  channels (``my_subband``), a full-band block fed to a subband process,
  an attached RFI monitor.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from dsabeamformer_tpu_torch.config import DSA110, TINY
from dsabeamformer_tpu_torch.ingest.generator import make_noise_block
from dsabeamformer_tpu_torch.models.calibration import CalTable
from dsabeamformer_tpu_torch.models.weights import make_weights
from dsabeamformer_tpu_torch.ops.quantize import (
    QuantWeights,
    load_quant_weights,
    prepare_weights,
)
from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor
from dsabeamformer_tpu_torch.parallel.multihost import (
    MultihostMeshStreamingBeamformer,
    initialize_multihost,
    my_subband,
)
from dsabeamformer_tpu_torch.parallel.sharding import (
    make_mesh,
    place_weights,
    sharded_beamformer,
)
from dsabeamformer_tpu_torch.pipeline import CollectSink, SyntheticSource

#: The wire block every process slices its subband from.
WIRE_SEED = 9
#: The second weight table's calibration (the update at block 2).
CAL_SEED = 5
N_STREAM = 8
UPDATE_AT = 2


def preset(name: str):
    if name == "tiny":
        return TINY
    if name == "dsa110s":
        # The DSA-110 deployment structure (128 antenna slots, 110 active,
        # the 2048-channel band frame) at test size: 16 channels over the
        # 8 slots of 4 processes x 2, 64 beams, 64 samples.
        return DSA110.replace(n_chan=16, n_chan_total=2048, t_block=64,
                              n_beams=64)
    raise SystemExit(f"unknown preset {name!r}")


def tables(cfg, args, device) -> tuple:
    """The two full-band tables: loaded (``--weights a.npz,b.npz``, the
    parent's bytes) or made here (unity, then a random calibration)."""
    if args.weights:
        return tuple(load_quant_weights(p, device=device)
                     for p in args.weights.split(","))
    return tuple(prepare_weights(cfg, make_weights(cfg, cal=cal,
                                                   device=device))
                 for cal in (None, CalTable.random(cfg, seed=CAL_SEED)))


def local_wire(cfg, sub) -> np.ndarray:
    """This process's capture: its subband of the seeded full-band block
    (host form ``[T, F_sub, P, A]``)."""
    wire = make_noise_block(cfg, rms=2.0, seed=WIRE_SEED)
    return np.ascontiguousarray(
        wire[:, sub.chan_start:sub.chan_start + sub.n_chan])


def run_step(cfg, sub, mesh, qw, wire) -> dict:
    sub_cfg = sub.config(cfg)
    sl = slice(sub.chan_start, sub.chan_start + sub.n_chan)
    qw_sh = place_weights(QuantWeights(tuple(t[sl] for t in qw.terms),
                                       qw.scales[sl]), mesh)
    out, band = sharded_beamformer(sub_cfg, mesh, with_band_power=True)(
        wire, qw_sh)
    band = band.cpu()
    dist.all_reduce(band)
    return {"step_out": out.cpu().numpy(), "step_band": band.numpy()}


def run_stream(cfg, sub, mesh, qw0, qw1, wire) -> dict:
    sink, bands = CollectSink(), {}
    bf = MultihostMeshStreamingBeamformer(
        cfg, qw0, SyntheticSource(sub.config(cfg), [wire], N_STREAM), sink,
        mesh=mesh, depth=2, with_band_power=True,
        on_band_power=lambda seq, band: bands.__setitem__(seq, band))

    def on_block(bs):
        if bs.block_idx == UPDATE_AT:
            # Every process swaps the same table at the same position.
            bf.update_weights(qw1)

    bf.on_block = on_block
    bf.warmup()
    stats = bf.run()
    if stats.n_blocks != N_STREAM or sorted(bands) != list(range(N_STREAM)):
        raise RuntimeError(f"stream: {stats.n_blocks} blocks, bands of "
                           f"{sorted(bands)}")
    return {"stream_seq": np.array([s for s, _ in sink.outputs]),
            "stream_out": np.stack([p for _, p in sink.outputs]),
            "stream_band": np.stack([bands[s] for s, _ in sink.outputs])}


def refusals(cfg, mesh, qw, device) -> dict:
    """The multihost stream's refusals, each message recorded."""
    got = {}
    try:
        sub = my_subband(cfg)
    except ValueError as e:
        return {"indivisible": str(e)}
    full = make_noise_block(cfg, rms=2.0, seed=WIRE_SEED)
    bf = MultihostMeshStreamingBeamformer(
        cfg, qw, SyntheticSource(cfg, [full], 1), CollectSink(), mesh=mesh)
    try:
        bf.run()
    except ValueError as e:
        got["full_band_block"] = str(e)
    try:
        bf.rfi_monitor = RFIMonitor(sub.config(cfg))
    except ValueError as e:
        got["rfi_monitor"] = str(e)
    try:
        bf.update_weights(prepare_weights(sub.config(cfg), make_weights(
            sub.config(cfg), device=device)))
    except ValueError as e:
        got["subband_table"] = str(e)
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--mode", default="step")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--weights")
    args = ap.parse_args()
    initialize_multihost(args.coordinator, args.world, args.rank,
                         backend=args.backend)
    try:
        cfg = preset(args.preset)
        device = torch.device(args.device)
        mesh = make_mesh(args.slots, devices=[device] * args.slots)
        qw0, qw1 = tables(cfg, args, device)
        results, refused = {}, {}
        for mode in args.mode.split("+"):
            if mode == "refuse":
                refused = refusals(cfg, mesh, qw0, device)
                continue
            sub = my_subband(cfg)
            wire = local_wire(cfg, sub)
            if mode == "step":
                results.update(run_step(cfg, sub, mesh, qw0, wire))
            elif mode == "stream":
                results.update(run_stream(cfg, sub, mesh, qw0, qw1, wire))
            else:
                raise SystemExit(f"unknown mode {mode!r}")
        out = Path(args.out)
        if results:
            sub = my_subband(cfg)
            np.savez(out / f"proc{args.rank}.npz", chan_start=sub.chan_start,
                     n_chan=sub.n_chan, **results)
        if refused:
            (out / f"proc{args.rank}.json").write_text(json.dumps(refused))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"proc {args.rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
