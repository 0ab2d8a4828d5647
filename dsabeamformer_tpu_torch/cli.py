"""Command-line interface of the PyTorch/CUDA port: ``dsabf-torch``.

Every subcommand of the JAX package's ``dsabf`` (its
``dsabeamformer_tpu/cli.py``), flag for flag:

  dsabf-torch run       — attach to a voltage ring (or file) and beamform
                          (the main real-time binary)
  dsabf-torch simulate  — synthetic capture process: write blocks into a
                          ring (the packet-capture stand-in for tests/demos)
  dsabf-torch weights   — generate/quantize/save weights
  dsabf-torch beampattern — render the formed-beam response (matplotlib)
  dsabf-torch selftest  — tiny end-to-end correctness check on a device
  dsabf-torch info      — device + config diagnostics
  dsabf-torch bench     — single-device benchmark (JSON line)
  dsabf-torch calibrate — solve antenna gains from a calibrator capture
  dsabf-torch ring      — inspect a ring's counters (dada_dbmonitor analog)
  dsabf-torch levels    — per-antenna rms + 4-bit clip report from a capture
  dsabf-torch rfi       — spectral-kurtosis RFI scan -> --zap/--flag-ants
  dsabf-torch launch    — supervised one-process-per-subband deployment
  dsabf-torch fil       — inspect a SIGPROC filterbank product
  dsabf-torch splice    — merge per-subband .fil products into one band
  dsabf-torch search    — single-pulse search of product files or live
                          product rings (joined across subbands)
  dsabf-torch waterfall — quick-look waterfall of a product (or a candidate)
  dsabf-torch fold      — fold a product at a pulsar period
  dsabf-torch trace     — profiler trace of a few block steps

``run``, ``selftest``, ``weights``, ``beampattern``, ``bench``,
``calibrate``, ``levels``, ``rfi``, ``search`` and ``trace`` take
``--device``: a card index (``0`` or ``cuda:0``) or ``cpu``; with none they
run on ``cuda:0`` and refuse to run without a card
(``utils.device.resolve_device``).  ``launch --devices`` takes the same
tokens, one per child.  ``run --mesh N`` streams through a channel mesh of
N slots (``parallel.sharding``): N distinct cards, or, with ``--device``, N
slots on that one device (the JAX package refuses ``--mesh`` with
``--device``; on a one-card host or the CPU this is how a mesh runs).

Run ``dsabf-torch <cmd> --help`` for flags.  Config presets come from
``dsabeamformer_tpu_torch.config``; any geometry field can be overridden
with ``--set key=value``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _coerce_field(current, val: str):
    """Parse a --set value with the type of the current field value.
    bool needs explicit token parsing: bool("false") is True."""
    if isinstance(current, bool):
        tok = val.strip().lower()
        if tok in ("true", "1", "yes", "on"):
            return True
        if tok in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"invalid bool value {val!r} (use true/false)")
    return type(current)(val)


def _load_cfg(args):
    from dsabeamformer_tpu_torch.config import presets

    table = presets()
    if args.config not in table:
        raise SystemExit(
            f"unknown config preset {args.config!r}; choose from "
            + " | ".join(table)
        )
    cfg = table[args.config]
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        field = getattr(cfg, key)  # raises AttributeError for bad key
        cfg = cfg.replace(**{key: _coerce_field(field, val)})
    if getattr(args, "subband", None):
        # "I/N": this process owns the I-th of N equal contiguous subbands
        # (the one-process-per-subband deployment as a single flag).
        # Applied after --set so overrides describe the FULL band.
        i_s, _, n_s = args.subband.partition("/")
        try:
            i, n = int(i_s), int(n_s)
        except ValueError:
            raise SystemExit(f"--subband must be I/N, got {args.subband!r}")
        if not (n > 0 and 0 <= i < n):
            raise SystemExit(f"--subband {args.subband}: need 0 <= I < N")
        if cfg.n_chan % n:
            raise SystemExit(
                f"--subband /{n} does not divide n_chan={cfg.n_chan}")
        width = cfg.n_chan // n
        # The slice frame, so that full-band channel specs (--zap) can be
        # translated into this process's local indices.
        args._full_n_chan = cfg.n_chan
        args._chan_offset = i * width
        cfg = cfg.subband(i * width, width)
    return cfg


def _add_common(p):
    p.add_argument("--config", default="dsa10",
                   help="config preset: dsa10 | dsa10c | dsa110 | tiny")
    p.add_argument("--set", action="append", metavar="KEY=VAL",
                   help="override any ObsConfig field, e.g. --set t_block=512")
    p.add_argument("--subband", metavar="I/N",
                   help="own the I-th of N equal subbands (the "
                        "process-per-subband deployment split)")


def _device_token(tok: str) -> str:
    """A ``--device`` / ``--devices`` token -> a torch device string: a card
    index (``0``) or ``cuda:N`` -> ``cuda:N``; ``cpu`` -> ``cpu``.  Raises
    ValueError for anything else."""
    t = tok.strip().lower()
    if t == "cpu":
        return "cpu"
    idx = t.removeprefix("cuda:")
    if not idx.isdigit():
        raise ValueError(f"device {tok!r}: give a card index (0, cuda:0) "
                         f"or cpu")
    return f"cuda:{int(idx)}"


def _device_arg(p, what) -> None:
    p.add_argument("--device",
                   help=f"{what}: a card index (0, cuda:0) or cpu "
                        f"(default: the first card; never the CPU unasked)")


def _resolve_device(args):
    """``args.device`` (default: the first card) as a torch device, or None
    after printing why it is refused (a card that is not there:
    resolve_device's message; callers return 2)."""
    from dsabeamformer_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(_device_token(args.device or "0"))
    except (ValueError, RuntimeError) as e:
        print(f"error: --device: {e}", file=sys.stderr)
        return None


def _host64(t) -> np.ndarray:
    """A scan's per-block float32 sums, on the host as float64 (what the
    accumulators across blocks are)."""
    return t.cpu().numpy().astype(np.float64)


def _capture_cfg(args, cfg):
    """Resolve the stream config for a capture-file input: a DADA header's
    geometry overrides the CLI config.  ``--subband`` describes a live
    deployment split and cannot be combined with a full-band capture file
    (the header would silently override the slice).  Returns (cfg,
    data_offset)."""
    from dsabeamformer_tpu_torch.ingest import dada

    if not os.path.exists(args.input_file):
        raise SystemExit(f"input file not found: {args.input_file}")
    if not dada.is_dada_file(args.input_file):
        return cfg, 0
    if getattr(args, "subband", None):
        raise SystemExit(
            "--subband cannot be combined with a DADA capture file: the "
            "file header defines the stream geometry (record per-subband "
            "captures instead)"
        )
    cfg, hdr, offset = dada.read_dada_file(args.input_file, cfg)
    return cfg, offset


def _scan_setup(args, default_ring_blocks=8):
    """Shared preamble of the scan commands (levels/rfi/calibrate):
    validate the capture-or-ring input choice and resolve the stream
    config.  Returns ``(cfg, offset)`` or None after printing the error
    (callers return 2).  Ring mode gets a bounded default block count so
    the command ends."""
    if bool(args.input_file) == bool(getattr(args, "key", None)):
        print("error: give exactly one of --input-file or --key",
              file=sys.stderr)
        return None
    if getattr(args, "key", None) and args.blocks is None:
        args.blocks = default_ring_blocks
    cfg = _load_cfg(args)
    if args.input_file:
        return _capture_cfg(args, cfg)
    return cfg, 0


def _iter_capture_blocks(args, cfg, offset, device):
    """Yield wire blocks, as uint8 tensors on ``device``, from
    ``args.input_file`` or, when ``args.key`` is set instead, from a live
    ring (the operator's pre-run scan against the actual stream), at most
    ``args.blocks`` when set.  On a card the ring is read by the pinned
    route: each slot is copied to the card and released at once."""
    import torch

    if getattr(args, "key", None) and not args.input_file:
        from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
        from dsabeamformer_tpu_torch.pipeline import RingSource

        timeout = getattr(args, "timeout", 5.0)
        ring = RingBuffer(args.key, connect_timeout_s=timeout)
        if ring.readers > 0:
            # The ring is single-consumer: every block this scan takes
            # never reaches the other reader (gaps in its products).
            print(f"[dsabf] WARNING: ring {args.key!r} already has "
                  f"{ring.readers} attached reader(s) — scanning "
                  f"CONSUMES blocks from the shared single-consumer "
                  f"cursor; the other consumer will see gaps.  Scan "
                  f"before starting the beamformer, not during.",
                  file=sys.stderr)
        src = RingSource(cfg, ring, timeout_s=timeout, n_host_buffers=2,
                         device=device)
        n = 0
        try:
            while args.blocks is None or n < args.blocks:
                item = src.read_block()
                if item is None:
                    if not ring.eod():
                        # A timeout, not end-of-data: a silent partial scan
                        # reads as a clean result.
                        print(f"[dsabf] WARNING: ring read timed out after "
                              f"{timeout:g}s with {n} of {args.blocks} "
                              f"blocks scanned (producer stalled?)",
                              file=sys.stderr)
                    break
                # The pinned route's view of the open slot: on the card
                # (a synchronous copy) before the slot goes back.
                blk = torch.as_tensor(item[1]).to(device)
                src.release()
                yield blk
                n += 1
        finally:
            src.close()
        return
    from dsabeamformer_tpu_torch.pipeline import FileSource

    src = FileSource(cfg, args.input_file, offset=offset)
    n = 0
    while args.blocks is None or n < args.blocks:
        item = src.read_block()
        if item is None:
            break
        yield torch.from_numpy(item[1]).to(device)
        n += 1


def _local_zap_chans(cfg, args):
    """--zap spec (FULL-band raw channel indices, so that one spec serves
    every `launch` child) -> this process's local channel list.
    Out-of-subband channels are not ours; out-of-band ones are an error."""
    from dsabeamformer_tpu_torch.models.weights import parse_zap

    chans = parse_zap(args.zap)
    full_n = getattr(args, "_full_n_chan", cfg.n_chan)
    bad = [c for c in chans if not 0 <= c < full_n]
    if bad:
        raise SystemExit(f"--zap channels {bad} out of range [0, {full_n})")
    off = getattr(args, "_chan_offset", 0)
    return [c - off for c in chans if off <= c < off + cfg.n_chan]


def _flag_ant_list(args):
    """--flag-ants spec -> sorted antenna index tuple (antennas are not
    subband-split: one spec serves every launch child verbatim)."""
    from dsabeamformer_tpu_torch.models.weights import parse_zap

    spec = getattr(args, "flag_ants", None)
    return tuple(parse_zap(spec)) if spec else ()


def _parse_beam_target(spec: str, n_beams=None):
    """A search-target spec -> ``"incoherent"``, ``"all"``, an int, or a
    list of ints; raises ValueError on a bad spec or (when ``n_beams`` is
    known) an out-of-range index."""
    s = spec.strip().lower()
    if s in ("inco", "incoherent"):
        return "incoherent"
    if s == "all":
        return "all"
    from dsabeamformer_tpu_torch.models.weights import parse_zap

    sel = parse_zap(spec)
    if n_beams is not None:
        bad = [b for b in sel if not 0 <= b < n_beams]
        if bad:
            raise ValueError(
                f"beam(s) {bad} out of range (0..{n_beams - 1})")
    return sel[0] if len(sel) == 1 else sel


def _emit_search_candidate(c):
    """One live-candidate JSON line on stderr (the FRB trigger feed)."""
    ev = {"snr": round(c.snr, 2), "dm": round(c.dm, 3),
          "time_s": round(c.time_s, 6), "width": c.width,
          "members": c.members}
    if c.beam >= 0:
        ev["beam"] = c.beam
    print("[dsabf] search " + json.dumps(ev), file=sys.stderr)


def _emit_search_rfi(ev):
    print("[dsabf] search rfi-coincidence " + json.dumps(ev),
          file=sys.stderr)


#: Tol-spaced DM grids scale as dm_max/tsamp; past this count the
#: [n_dm, F] delay table alone is GBs: fail with the knobs named.
_DM_TRIAL_CAP = 262144


def _epoch_meta(meta) -> dict:
    """Observation-epoch fields from a product header, for .cand files
    (candidate times are product-relative; the epoch anchors them): .fil
    tstart [MJD], DADA MJD_START / UTC_START when stamped."""
    out = {}
    if meta.get("tstart"):
        out["tstart_mjd"] = meta["tstart"]
    if meta.get("MJD_START"):
        out["tstart_mjd"] = meta["MJD_START"]
    if meta.get("UTC_START"):
        out["utc_start"] = meta["UTC_START"]
    return out


def _dm_grid_error(dms, tsamp, dm_max):
    if len(dms) <= _DM_TRIAL_CAP:
        return None
    return (f"DM grid has {len(dms)} trials (tsamp={tsamp:.3g}s, "
            f"dm_max={dm_max:g}) — lower --dm-max, raise --dm-tol, or "
            f"set an explicit --dm-step")


def _make_weights(cfg, args, device, extra_zap=()):
    """Generate + quantize the run's weights on ``device`` from the CLI
    flags.  ``extra_zap`` (LOCAL channel indices) unions with ``--zap``:
    the streaming RFI monitor's regeneration path (``--rfi-auto``)."""
    from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
    from dsabeamformer_tpu_torch.models.calibration import CalTable
    from dsabeamformer_tpu_torch.models.weights import (
        flag_antennas, make_weights, zap_weights,
    )
    from dsabeamformer_tpu_torch.ops.quantize import (
        load_quant_weights, prepare_weights,
    )

    if getattr(args, "weights", None):
        baked = [f for f in ("zap", "flag_ants") if getattr(args, f, None)]
        if baked:
            opts = ", ".join("--" + f.replace("_", "-") for f in baked)
            raise SystemExit(
                f"{opts} edits weights at generation time and cannot be "
                f"applied to pre-quantized --weights; re-run `dsabf-torch "
                f"weights {opts} ...`")
        return load_quant_weights(args.weights, device=device)
    layout = (ArrayLayout.load(args.layout)
              if getattr(args, "layout", None) else None)
    cal = CalTable.load(args.cal) if getattr(args, "cal", None) else None
    w = make_weights(cfg, layout=layout, cal=cal,
                     pointing_rad=getattr(args, "pointing", 0.0),
                     device=device)
    zap = set(extra_zap)
    if getattr(args, "zap", None):
        zap |= set(_local_zap_chans(cfg, args))
    if zap:
        w = zap_weights(w, sorted(zap), cfg)
    flags = _flag_ant_list(args)
    if flags:
        try:
            w = flag_antennas(w, flags, cfg)
        except ValueError as e:
            raise SystemExit(str(e))
    return prepare_weights(cfg, w)


class _MaskedSink:
    """The incoherent product with the zapped averaged groups zeroed: it is
    data-side, so weight zapping cannot touch it (conservative: any zapped
    raw channel kills its group)."""

    def __init__(self, inner, mask):
        self.inner, self.mask = inner, mask[:, None]

    def write(self, seq, arr):
        self.inner.write(seq, np.asarray(arr) * self.mask)

    def close(self):
        self.inner.close()


class _DiscardSink:
    """Turns on the fused incoherent product for the search monitor when no
    --incoherent-file is wanted."""

    def write(self, seq, arr):
        pass

    def close(self):
        pass


def cmd_run(args) -> int:
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.pipeline import (
        FileSink, FileSource, MeshStreamingBeamformer, RingSink, RingSource,
        StreamingBeamformer,
    )

    if args.fil_dir and (args.output_file or args.output_key):
        print("error: --fil-dir is exclusive with --output-file/"
              "--output-key (one product sink per run)", file=sys.stderr)
        return 2
    device = None
    if not args.mesh or args.device is not None:
        device = _resolve_device(args)
        if device is None:
            return 2

    cfg = _load_cfg(args)
    dada_offset = 0
    if args.input_file:
        cfg2, dada_offset = _capture_cfg(args, cfg)
        if dada_offset:
            cfg = cfg2
            print(f"[dsabf] DADA header: {cfg.n_chan} chan x {cfg.n_ant} "
                  f"ant x {cfg.n_pol} pol, order {cfg.input_layout}, "
                  f"data at +{dada_offset}", file=sys.stderr)
    mesh = None
    if args.mesh:
        from dsabeamformer_tpu_torch.parallel.sharding import (
            _check_divisible, make_mesh,
        )

        try:
            # The shard geometry is checked first, with the port's own
            # messages; then the slots: N on --device, else N distinct cards.
            _check_divisible(cfg, args.mesh)
            mesh = make_mesh(args.mesh, devices=None if device is None
                             else [device] * args.mesh)
        except ValueError as e:
            print(f"error: --mesh {args.mesh}: {e}", file=sys.stderr)
            return 2
        device = mesh.home
    if args.products == "stokes":
        inflight_gb = (args.depth * 4 * np.prod(cfg.out_block_shape) * 4
                       / 2**30)
        if inflight_gb > 6:
            print(f"[dsabf] WARNING: stokes at t_block={cfg.t_block} with "
                  f"--depth {args.depth} keeps ~{inflight_gb:.1f} GB of "
                  f"Stokes output in flight and can exhaust device memory "
                  f"— use t_block<=4096 captures or a smaller --depth",
                  file=sys.stderr)
    # Construct (and thereby validate) every sink before the weight
    # generation and the warmup: a bad --fil-bits/--fil-beams/--fil-scale
    # or path fails at once with a clean error.
    out_mult = 4 if args.products == "stokes" else 1
    sink = None
    inco_sink = None
    # Observation epoch, stamped into every product header (PSRDADA
    # convention: UTC_START; .fil carries tstart MJD).
    epoch_hdr = {}
    if args.utc_start:
        epoch_hdr["UTC_START"] = args.utc_start
    if args.tstart_mjd:
        epoch_hdr["MJD_START"] = repr(args.tstart_mjd)
    try:
        if args.fil_dir:
            from dsabeamformer_tpu_torch.ingest.sigproc import FilterbankSink

            beams = ([int(b) for b in args.fil_beams.split(",")]
                     if args.fil_beams else None)
            scale = (args.fil_scale if args.fil_scale == "auto"
                     else float(args.fil_scale))
            sink = FilterbankSink(args.fil_dir, cfg, beams=beams,
                                  products=args.products,
                                  tstart_mjd=args.tstart_mjd,
                                  nbits=args.fil_bits, scale=scale)
        elif args.output_file:
            sink = FileSink(args.output_file, cfg, products=args.products,
                            extra_header=epoch_hdr)
        elif args.output_key:
            out_bytes = int(np.prod(cfg.out_block_shape)) * 4 * out_mult
            out_ring = RingBuffer(args.output_key, create=True,
                                  nbufs=args.nbufs, bufsz=out_bytes)
            sink = RingSink(out_ring, cfg, products=args.products,
                            extra_header=epoch_hdr)
        inco_sink = (FileSink(args.incoherent_file, cfg,
                              products="incoherent",
                              extra_header=epoch_hdr)
                     if args.incoherent_file else None)
        if inco_sink is not None and getattr(args, "zap", None):
            from dsabeamformer_tpu_torch.models.weights import zap_mask_avg

            inco_sink = _MaskedSink(
                inco_sink, zap_mask_avg(_local_zap_chans(cfg, args), cfg))
    except ValueError as e:
        if sink is not None:
            sink.close()
        print(f"error: {e}", file=sys.stderr)
        return 2

    # Live single-pulse search (ops/dedisperse.py SearchMonitor).  Built
    # before the beamformer because an incoherent-sum target needs the
    # fused incoherent product turned on at construction.
    search_monitor = None
    if args.search_dm_max is not None:
        from dsabeamformer_tpu_torch.ops.dedisperse import SearchMonitor

        try:
            # target: 'incoherent', one index, a '3,7,100-110' set, or
            # 'all' (sets/'all' search beam-batched with live cross-beam
            # coincidence RFI rejection)
            target = _parse_beam_target(args.search_beam, cfg.n_beams)
            sm_inco = target == "incoherent"
            beam_arg = 0 if sm_inco else target
            search_monitor = SearchMonitor.for_stream(
                cfg, args.search_dm_max, beam=beam_arg,
                incoherent=sm_inco, threshold=args.search_threshold,
                chunk_t=args.search_chunk, zerodm=args.search_zerodm,
                method=args.search_method,
                on_candidate=_emit_search_candidate,
                coincidence=not args.search_no_coincidence,
                coincidence_frac=args.search_coincidence_frac,
                on_rfi=_emit_search_rfi, device=device)
        except ValueError as e:
            if sink is not None:
                sink.close()
            print(f"error: {e}", file=sys.stderr)
            return 2
        dms = search_monitor.dms
        if sm_inco and inco_sink is None:
            inco_sink = _DiscardSink()
        target = ("incoherent sum" if sm_inco
                  else f"all {cfg.n_beams} beams" if beam_arg == "all"
                  else f"beams {args.search_beam}"
                  if isinstance(beam_arg, list) else f"beam {beam_arg}")
        print(f"[dsabf] search: {len(dms)} DM trials "
              f"[0, {dms[-1]:.1f}] on {target}, "
              f"threshold {args.search_threshold:g}, window "
              f"{args.search_chunk} samples "
              f"(+{search_monitor.overlap} carried)", file=sys.stderr)

    qw = _make_weights(cfg, args, device)

    # The beamformer's sink goes in now so that its device-side transform
    # (the 8-bit .fil quantizer and layout) is built during warmup too.
    if mesh is not None:
        warm = MeshStreamingBeamformer(cfg, qw, source=None, sink=sink,
                                       mesh=mesh, products=args.products,
                                       incoherent_sink=inco_sink,
                                       flag_ants=_flag_ant_list(args))
        print(f"[dsabf] mesh: {args.mesh} device(s) x "
              f"{cfg.n_chan // args.mesh} channels each", file=sys.stderr)
    else:
        warm = StreamingBeamformer(cfg, qw, source=None, sink=sink,
                                   products=args.products,
                                   incoherent_sink=inco_sink,
                                   flag_ants=_flag_ant_list(args))
    warm.search_monitor = search_monitor

    rfi_monitor = None
    if args.rfi_auto:
        if args.weights:
            print("error: --rfi-auto regenerates weights on excision and "
                  "cannot edit pre-quantized --weights; drop one of the "
                  "two flags", file=sys.stderr)
            if sink is not None:
                sink.close()
            return 2
        from dsabeamformer_tpu_torch.ops.rfi import RFIMonitor

        chan0 = getattr(args, "_chan_offset", 0)

        def _rfi_auto_event(ev):
            # Logged in the FULL-band frame (what --zap speaks).
            shown = dict(ev)
            for k in ("new", "zapped", "flagged"):
                if k in shown:
                    shown[k] = [chan0 + c for c in shown[k]]
            print(f"[dsabf] rfi {json.dumps(shown)}", file=sys.stderr)
            if ev["type"] != "excise" or ev.get("final"):
                # Cap refusals are log-only; flush-time excisions have no
                # blocks left to apply to.
                return
            if warm.tracker is not None:
                # A tracked run regenerates at the current pointing: the
                # tracker's next poll rebuilds with the grown zap set (its
                # edit hook folds it in).
                warm.tracker.invalidate()
                return
            # Untracked: regenerate with the full sticky zap set and swap
            # in through the stream's update path.  The incoherent product
            # is data-side and keeps its startup mask.
            warm.update_weights(
                _make_weights(cfg, args, device, extra_zap=ev["zapped"]))

        try:
            rfi_monitor = RFIMonitor(
                cfg,
                interval=args.rfi_interval,
                sample=args.rfi_sample,
                threshold=args.rfi_threshold,
                max_fraction=args.rfi_max_fraction,
                on_event=_rfi_auto_event,
                seed_zapped=(_local_zap_chans(cfg, args)
                             if getattr(args, "zap", None) else ()),
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            if sink is not None:
                sink.close()
            return 2
        warm.rfi_monitor = rfi_monitor

    warm.warmup()

    if args.input_file:
        source = FileSource(cfg, args.input_file, offset=dada_offset)
    else:
        ring = RingBuffer(args.key, connect_timeout_s=args.timeout)
        from dsabeamformer_tpu_torch.pipeline import staging_pool_size

        # On a card the ring's own slots are the staging buffers (the
        # pinned-ring route); on the CPU a pool sized by the shared rule.
        source = RingSource(cfg, ring, latest=args.latest,
                            timeout_s=args.timeout,
                            n_host_buffers=staging_pool_size(
                                cfg.wire_block_bytes, args.depth),
                            device=device)

    stats_f = open(args.stats_file, "a") if args.stats_file else None
    block_trace = None
    if args.trace_blocks:
        from dsabeamformer_tpu_torch.utils import profiling

        # Steady state: past the pipeline's fill and the first drains.
        block_trace = profiling.BlockTrace(
            args.trace_blocks, skip=args.depth + 2,
            log_dir=profiling.DEFAULT_LOG_DIR, device=device)

    def report_trace(path):
        if path is not None:
            print(f"[dsabf] trace of {args.trace_blocks} block(s): {path}",
                  file=sys.stderr)

    def on_block(bs):
        if args.verbose:
            print(bs.line(cfg), file=sys.stderr)
        if stats_f is not None:
            rec = dict(block=bs.block_idx, seq=bs.seq, wall_s=bs.wall_s,
                       bytes=bs.bytes_in, dropped=bs.dropped,
                       skipped=bs.skipped, read_s=bs.read_s,
                       enqueue_s=bs.enqueue_s, h2d_wait_s=bs.h2d_wait_s,
                       inflight_s=bs.inflight_s,
                       drain_wait_s=bs.drain_wait_s, sinks_s=bs.sinks_s,
                       rfi_s=bs.rfi_s)
            stats_f.write(json.dumps(rec) + "\n")
        if block_trace is not None:
            report_trace(block_trace.drained())

    if args.track:
        from dsabeamformer_tpu_torch.models.calibration import CalTable
        from dsabeamformer_tpu_torch.models.tracking import FringeTracker

        cal = CalTable.load(args.cal) if args.cal else None
        # Excision must survive the tracker's regeneration: --zap /
        # --flag-ants, plus the channels the RFI monitor has excised since
        # (its zap set is sticky and grows), go into every fresh table.
        edit = None
        zap_local = (_local_zap_chans(cfg, args)
                     if getattr(args, "zap", None) else [])
        flags = _flag_ant_list(args)
        if zap_local or flags or rfi_monitor is not None:
            from dsabeamformer_tpu_torch.models.weights import (
                flag_antennas, zap_weights,
            )

            def edit(w, _z=zap_local, _f=flags):
                z = set(_z)
                if rfi_monitor is not None:
                    z |= rfi_monitor.zapped
                if z:
                    w = zap_weights(w, sorted(z), cfg)
                if _f:
                    w = flag_antennas(w, _f, cfg)
                return w

        warm.tracker = FringeTracker(
            cfg, cal=cal, pointing0_rad=args.pointing,
            declination_rad=args.declination, edit=edit, device=device,
        )
    warm.source = source
    warm.depth = args.depth
    warm.on_block = on_block
    # Every exit path (completion, operator Ctrl-C, an exception out of the
    # loop) flushes and closes the product sinks and the stats file, or the
    # tail blocks of a .dada product would be lost.
    try:
        stats = warm.run(max_blocks=args.blocks)
    except KeyboardInterrupt:
        # Operator stop: report what was processed, clocked from the loop
        # start.
        print(warm.current_stats().json_line(cfg))
        return 130
    finally:
        if block_trace is not None:
            report_trace(block_trace.stop())
        if hasattr(source, "close"):
            source.close()
        if sink is not None:
            out_drops = getattr(sink, "dropped", 0)
            if out_drops:
                # The writer never blocks (the real-time contract), but the
                # loss must be visible: an absent or slow downstream
                # consumer otherwise silently eats product blocks.
                print(f"[dsabf] WARNING: output ring dropped "
                      f"{out_drops} product block(s) — downstream "
                      f"consumer absent or too slow (it sees seq gaps)",
                      file=sys.stderr)
            sink.close()
            if getattr(sink, "nbits", 32) == 8:
                print(f"[dsabf] 8-bit per-beam scales written to "
                      f"{args.fil_dir}/scales.json", file=sys.stderr)
            if getattr(sink, "n_splices", 0):
                print(f"[dsabf] WARNING: {sink.n_splices} stream gap(s) "
                      f"zero-filled in .fil output "
                      f"({sink.filled_samples} samples)", file=sys.stderr)
        if inco_sink is not None:
            inco_sink.close()
        if stats_f is not None:
            stats_f.close()
        if search_monitor is not None:
            # Interrupt paths skip run()'s own flush; flushing twice is
            # harmless (the buffer empties on the first).
            search_monitor.flush()
            sm = search_monitor
            print(f"[dsabf] search: {len(sm.candidates)} candidate(s) in "
                  f"{sm.searched_windows} window(s)"
                  + (f", {sm.rfi_rejected} coincidence-rejected RFI "
                     f"cluster(s)" if sm.rfi_rejected else "")
                  + (f", {sm.gaps} stream gap(s) reset the sweep buffer"
                     if sm.gaps else ""), file=sys.stderr)
            if args.search_cand:
                from dsabeamformer_tpu_torch.ops.dedisperse import (
                    write_candidates,
                )

                cands = sorted(sm.candidates, key=lambda c: -c.snr)
                write_candidates(args.search_cand, cands, {
                    "config": cfg.name, "beam": args.search_beam,
                    "tsamp_s": sm.tsamp_s, "n_dm_trials": len(sm.dms),
                    "dm_max": sm.dms[-1],
                    "threshold": sm.threshold, "live": True,
                })
                print(f"[dsabf] search: wrote {args.search_cand}",
                      file=sys.stderr)
    print(stats.json_line(cfg))
    return 0


def cmd_simulate(args) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.generator import (
        make_dispersed_pulse_block, make_noise_block,
        make_point_source_block,
    )
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    cfg = _load_cfg(args)
    if args.distinct < 1:
        print("error: --distinct must be >= 1", file=sys.stderr)
        return 2
    first_block = None
    pulsar_angle = None
    if args.pulse_period is not None:
        # Injected-pulsar drill: every block is made afresh with t0 shifted
        # by -i * t_block, so that the train stays phase-coherent across
        # block boundaries.
        if args.pulse_period <= args.pulse_width:
            print(f"error: --pulse-period {args.pulse_period} must "
                  f"exceed --pulse-width {args.pulse_width}",
                  file=sys.stderr)
            return 2
        pulsar_angle = np.deg2rad(args.source_angle or 0.0)
    # The drill's first block and the pool are made on two threads (NumPy's
    # generators and ufuncs release the GIL): the same bytes, the slowest
    # one (the pulse) started first.
    with ThreadPoolExecutor(max_workers=2) as maker:
        if args.pulse_period is None and args.pulse_dm is not None:
            # Injected-FRB drill: the FIRST emitted block only (a pulse in
            # the cycled pool would repeat every --distinct blocks) carries
            # a dispersed pulse on the same noise floor.
            first_block = maker.submit(
                make_dispersed_pulse_block, cfg, args.pulse_dm,
                angle_rad=np.deg2rad(args.source_angle or 0.0),
                t0_sample=args.pulse_t0, width_samples=args.pulse_width,
                noise_rms=args.rms, seed=1234)
        pool = []
        if args.pulse_period is None:  # pulsar mode never reads the pool
            for s in range(args.distinct):
                if args.source_angle is not None:
                    pool.append(maker.submit(
                        make_point_source_block, cfg,
                        np.deg2rad(args.source_angle), seed=s))
                else:
                    pool.append(maker.submit(make_noise_block, cfg,
                                             rms=args.rms, seed=s))
        blocks = [f.result() for f in pool]
        if first_block is not None:
            first_block = first_block.result()

    def block_at(i):
        if pulsar_angle is not None:
            return make_dispersed_pulse_block(
                cfg, args.pulse_dm or 0.0, angle_rad=pulsar_angle,
                t0_sample=args.pulse_t0 - i * cfg.t_block,
                width_samples=args.pulse_width,
                period_samples=args.pulse_period,
                noise_rms=args.rms, seed=1234 + i)
        if i == 0 and first_block is not None:
            return first_block
        return blocks[i % len(blocks)]
    if args.out_file:
        # Capture to disk: a DADA file `run --input-file` (or any PSRDADA
        # consumer) can replay.
        n = args.blocks if args.blocks is not None else 32
        dada.write_dada_file(
            args.out_file, cfg,
            (block_at(i) for i in range(n)),
        )
        print(json.dumps({"written": n, "out_file": args.out_file}))
        return 0
    with RingBuffer(args.key, create=True, nbufs=args.nbufs,
                    bufsz=cfg.wire_block_bytes) as ring:
        ring.write_header(dada.encode_header(cfg))
        t0 = time.perf_counter()
        i = 0
        while args.blocks is None or i < args.blocks:
            if args.rate:
                due = i * cfg.block_duration_s / args.rate
                now = time.perf_counter() - t0
                if now < due:
                    time.sleep(due - now)
            ring.write_block(block_at(i))
            i += 1
        ring.set_eod()
        # A window for the consumer to drain before the segment vanishes.
        deadline = time.perf_counter() + args.linger
        while time.perf_counter() < deadline and not ring.eod():
            time.sleep(0.05)
        print(json.dumps({"written": i, "dropped": ring.dropped}))
    return 0


def cmd_weights(args) -> int:
    from dsabeamformer_tpu_torch.ops.quantize import save_quant_weights

    cfg = _load_cfg(args)
    device = _resolve_device(args)
    if device is None:
        return 2
    qw = _make_weights(cfg, args, device)
    save_quant_weights(args.out, qw)
    print(json.dumps({
        "out": args.out,
        "mode": cfg.weight_mode,
        "terms": qw.n_terms,
        "shape": [qw.n_terms] + list(qw.terms[0].shape),
    }))
    return 0


def cmd_beampattern(args) -> int:
    """Render the formed-beam response, computed on ``--device``.  Without
    matplotlib (an optional dependency) it exits 2 with one line naming
    it."""
    from dsabeamformer_tpu_torch.models.beampattern import plot_beam_pattern

    cfg = _load_cfg(args)
    device = _resolve_device(args)
    if device is None:
        return 2
    try:
        path = plot_beam_pattern(cfg, args.out, n_sweep=args.sweep,
                                 device=device)
    except ImportError as e:
        if "matplotlib" not in str(e):
            raise
        print(f"error: beampattern renders with matplotlib, which this "
              f"host lacks ({e})", file=sys.stderr)
        return 2
    print(json.dumps({"out": path, "beams": cfg.n_beams}))
    return 0


def cmd_selftest(args) -> int:
    import torch

    from dsabeamformer_tpu_torch.config import TINY
    from dsabeamformer_tpu_torch.ingest.generator import make_point_source_block
    from dsabeamformer_tpu_torch.models.weights import (
        make_weights, weights_numpy_golden,
    )
    from dsabeamformer_tpu_torch.ops.gemm import beamform_power
    from dsabeamformer_tpu_torch.ops.quantize import prepare_weights
    from dsabeamformer_tpu_torch.ops.reference import beamform_block_ref
    from dsabeamformer_tpu_torch.utils.testing import (
        POWER_RTOL, relative_power_error,
    )

    device = _resolve_device(args)
    if device is None:
        return 2
    cfg = TINY if args.config == "tiny" else _load_cfg(args)
    angles = cfg.beam_angles_rad()
    target = cfg.n_beams // 3
    wire = make_point_source_block(cfg, angles[target], noise_rms=0.3, seed=1)
    qw = prepare_weights(cfg, make_weights(cfg, device=device))
    p = beamform_power(torch.from_numpy(wire).to(device), qw, cfg)
    p = p.cpu().numpy()
    peak = int(np.argmax(p.sum(axis=(0, 1))))
    p_ref = beamform_block_ref(
        weights_numpy_golden(cfg), wire, cfg.input_layout, cfg.navg_time,
        cfg.navg_freq,
    )
    err = relative_power_error(p, p_ref)
    ok = peak == target and err <= POWER_RTOL
    print(json.dumps({
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "beam_expected": target,
        "beam_peak": peak,
        "rel_power_error": err,
        "bar": POWER_RTOL,
        "ok": ok,
    }))
    return 0 if ok else 1


def cmd_info(args) -> int:
    import torch

    from dsabeamformer_tpu_torch import __version__
    from dsabeamformer_tpu_torch.pipeline import staging_pool_size
    from dsabeamformer_tpu_torch.utils.metrics import peak_macs_per_s

    cfg = _load_cfg(args)
    cuda = torch.cuda.is_available()
    devs = [torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())] if cuda else []
    print(json.dumps({
        "version": __version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": devs,
        "n_devices": len(devs),
        "peak_int8_macs_per_s":
            peak_macs_per_s(devs[0], "int8x2") if devs else None,
        # bench and the stats record give two labeled accountings
        # (utils.metrics.tensor_core_utilization); this ratio converts
        # between them: padded_k = issued * ratio.
        "tc_padded_k_over_issued": round(cfg.n_ant / cfg.a_compute, 4),
        "config": cfg.name,
        "wire_block_bytes": cfg.wire_block_bytes,
        "block_duration_s": cfg.block_duration_s,
        "realtime_gb_per_s": round(cfg.realtime_bytes_per_s / 1e9, 3),
        "out_block_shape": list(cfg.out_block_shape),
        "weight_mode": cfg.weight_mode,
        # Deployment sizing at the default --depth 2: the stream keeps
        # depth+1 wire blocks in device memory and stages depth+2 in host
        # RAM (blocks under 512 MiB keep an 8-buffer staging floor); `run`
        # from a ring on a card stages in the ring's own slots instead, and
        # `simulate` holds an nbufs-deep ring in /dev/shm.
        "weight_bytes": cfg.n_chan * cfg.gemm_k * 2 * cfg.n_beams
                        * cfg.n_weight_terms
                        * {"f32": 4, "bf16": 2, "bf16x2": 2}.get(
                            cfg.weight_mode, 1),
        "hbm_wire_bytes_depth2": 3 * cfg.wire_block_bytes,
        "host_staging_bytes_depth2":
            staging_pool_size(cfg.wire_block_bytes, 2)
            * cfg.wire_block_bytes,
    }))
    return 0


def cmd_bench(args) -> int:
    from dsabeamformer_tpu_torch.utils.bench import run_benchmark

    cfg = _load_cfg(args)
    device = _resolve_device(args)
    if device is None:
        return 2
    result = run_benchmark(cfg, n_blocks=args.blocks, mode=args.bench_mode,
                           device=device)
    print(json.dumps(result))
    return 0


def cmd_calibrate(args) -> int:
    """Solve per-antenna complex gains from a recorded calibrator capture
    or a live ring (models/calsolver.py, summed on ``--device``) and save
    the CalTable for ``run --cal`` / ``weights --cal``."""
    from dsabeamformer_tpu_torch.models.arrays import ArrayLayout
    from dsabeamformer_tpu_torch.models.calsolver import solve_gains_blocks

    scan = _scan_setup(args)
    if scan is None:
        return 2
    cfg, offset = scan
    device = _resolve_device(args)
    if device is None:
        return 2
    layout = ArrayLayout.load(args.layout) if args.layout else None
    n_seen = 0

    def blocks():
        nonlocal n_seen
        for blk in _iter_capture_blocks(args, cfg, offset, device):
            n_seen += 1
            yield blk

    try:
        cal = solve_gains_blocks(blocks(), cfg, np.deg2rad(args.angle),
                                 layout=layout, ref_ant=args.ref_ant,
                                 device=device)
    except ValueError as e:
        if "no blocks" in str(e):
            print(f"no blocks in "
                  f"{args.input_file or 'ring ' + repr(args.key)}",
                  file=sys.stderr)
            return 1
        raise
    cal.save(args.out)
    act = cfg.n_ant_active
    print(json.dumps({
        "out": args.out,
        "blocks": n_seen,
        "n_ant": cfg.n_ant,  # padded slot count, as everywhere in the CLI
        "n_ant_active": act,
        "n_chan": cfg.n_chan,
        "median_amp": float(np.median(np.abs(cal.gains[:act]))),
        "max_phase_rad": float(
            np.abs(np.angle(cal.gains[:act] / cal.gains[args.ref_ant]))
            .max()
        ),
    }))
    return 0


def cmd_launch(args) -> int:
    """Spawn the one-process-per-subband deployment: N `dsabf-torch run`
    children, child i owning subband i/N (and the device named i-th by
    --devices, whose entries take --device's tokens: a card index or
    cpu; a card may be named more than once).  Supervises them and
    aggregates their exit codes into one JSON report.

    Occurrences of ``{i}`` / ``{n}`` in the forwarded run arguments are
    replaced per child (ring keys, output files, stats files):

        dsabf-torch launch --subbands 8 --devices 0,1,2,3,4,5,6,7 -- \\
            --config dsa110 --key capture{i} --output-file out{i}.dada
    """
    import signal
    import subprocess

    n = args.subbands
    if n < 1:
        print("error: --subbands must be >= 1", file=sys.stderr)
        return 2
    devices = None
    if args.devices:
        try:
            devices = [_device_token(d) for d in args.devices.split(",")]
        except ValueError as e:
            print(f"error: --devices: {e}", file=sys.stderr)
            return 2
        if len(devices) != n:
            print(f"error: --devices lists {len(devices)} devices for "
                  f"{n} subbands", file=sys.stderr)
            return 2
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    procs = []
    try:
        for i in range(n):
            argv = ["run"]
            for a in rest:
                argv.append(a.replace("{i}", str(i)).replace("{n}", str(n)))
            argv += ["--subband", f"{i}/{n}"]
            if devices is not None:
                argv += ["--device", devices[i]]
            # A new session: the terminal would otherwise deliver its own
            # SIGINT to every child besides the one forwarded, and the
            # second KeyboardInterrupt would land in the child's sink flush.
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dsabeamformer_tpu_torch.cli"] + argv,
                stdout=subprocess.PIPE, text=True,
                start_new_session=True))
        outs = []
        for i, p in enumerate(procs):
            out, _ = p.communicate()
            last = out.strip().splitlines()[-1] if out.strip() else ""
            try:
                rec = json.loads(last)
            except ValueError:
                rec = {"raw": last}
            outs.append({"subband": f"{i}/{n}", "rc": p.returncode, **rec})
    except KeyboardInterrupt:
        # Operator stop: forward it and collect the children's own
        # interrupted-exit reports.
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                # A wedged child: kill it and record the signal's rc.
                p.kill()
                p.wait()
        print(json.dumps({"interrupted": True,
                          "rcs": [p.returncode for p in procs]}))
        return 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
    # A signal-killed child has a negative returncode: any nonzero rc is a
    # failed subband.
    bad = [o["rc"] for o in outs if o["rc"] != 0]
    print(json.dumps({"subbands": outs, "ok": not bad}))
    # Shell convention for the exit code: 128+signal for signal deaths.
    return max((rc if rc > 0 else 128 - rc) for rc in bad) if bad else 0


def cmd_fil(args) -> int:
    """Inspect a SIGPROC filterbank product: header + payload stats +
    bandpass summary (sanity-check a product before the search stage)."""
    from dsabeamformer_tpu_torch.ingest.sigproc import read_filterbank

    try:
        hdr, data = read_filterbank(args.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    x = data.astype(np.float64)
    # Level stats from IF 0 (Stokes I) only: Q/U/V have near-zero means
    # (f32) or ride the 128 midpoint offset (8-bit).  The per-IF means are
    # reported separately for Stokes files.
    bp = x[:, 0, :].mean(axis=0)
    out = dict(
        hdr,
        n_samples=int(data.shape[0]),
        duration_s=data.shape[0] * hdr["tsamp"],
        mean=float(x[:, 0, :].mean()),
        std=float(x[:, 0, :].std()),
        bandpass_min=float(bp.min()),
        bandpass_max=float(bp.max()),
        bandpass_ripple=float(bp.max() / bp.min()) if bp.min() > 0 else None,
        finite=bool(np.isfinite(x).all()),
    )
    if data.shape[1] > 1:
        out["if_means"] = [round(float(x[:, s, :].mean()), 3)
                           for s in range(data.shape[1])]
    print(json.dumps(out))
    return 0


def cmd_splice(args) -> int:
    """Merge per-subband .fil products into one full-band file (the step
    after `launch`'s per-subband split: each child writes its own band
    slice; the search stage wants one file)."""
    from dsabeamformer_tpu_torch.ingest.sigproc import splice_filterbanks

    try:
        hdr = splice_filterbanks(args.inputs, args.out)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    bad_scales = hdr.get("_subband_scales")
    if bad_scales is not None:
        if all(s is None for s in bad_scales):
            print("[dsabf] WARNING: 8-bit inputs have no scales.json "
                  "sidecars — per-subband quantization scales are "
                  "UNKNOWN and may differ (stepped bandpass); record "
                  "splice-bound products with an explicit --fil-scale",
                  file=sys.stderr)
        else:
            print(f"[dsabf] WARNING: 8-bit inputs carry different "
                  f"per-subband quantization scales {bad_scales} — the "
                  f"merged counts have a stepped bandpass; record "
                  f"splice-bound products with an explicit --fil-scale",
                  file=sys.stderr)
    print(json.dumps({
        "out": args.out,
        "inputs": len(args.inputs),
        "nchans": hdr["nchans"],
        "fch1": hdr["fch1"],
        "n_samples": hdr["_n_samples"],
        "dropped_trailing_samples": hdr["_dropped_samples"],
    }))
    return 0


def cmd_rfi(args) -> int:
    """Spectral-kurtosis RFI scan of a capture: per-channel SK accumulated
    over all blocks, robust cross-channel flagging, and a ready-to-paste
    ``--zap`` spec (full-band raw indices, what ``run --zap`` takes).  SK
    ~= 1 for Gaussian noise; CW carriers pull it far below 1, impulsive
    RFI far above.  The per-block sums run on ``--device``."""
    from dsabeamformer_tpu_torch.ops.incoherent import (
        format_zap_spec,
        sk_block_stats,
        sk_estimate,
        sk_flags,
        sk_samples_per_block,
    )

    scan = _scan_setup(args)
    if scan is None:
        return 2
    cfg, offset = scan
    device = _resolve_device(args)
    if device is None:
        return 2
    s1 = np.zeros(cfg.n_chan, np.float64)
    s2 = np.zeros(cfg.n_chan, np.float64)
    a1 = np.zeros(cfg.n_ant_active, np.float64)
    a2 = np.zeros(cfg.n_ant_active, np.float64)
    n = 0
    for blk in _iter_capture_blocks(args, cfg, offset, device):
        # axis="both": channel and antenna accumulators from one unpack.
        st = sk_block_stats(blk, cfg,
                            axis="both" if args.per_ant else "chan")
        s1 += _host64(st["s1"])
        s2 += _host64(st["s2"])
        if args.per_ant:
            a1 += _host64(st["ant_s1"])
            a2 += _host64(st["ant_s2"])
        n += 1
    if n == 0:
        print(f"no blocks in "
              f"{args.input_file or 'ring ' + repr(args.key)}",
              file=sys.stderr)
        return 1
    m = n * sk_samples_per_block(cfg)
    sk = sk_estimate(s1, s2, m)
    flagged, med, sigma = sk_flags(sk, m, threshold=args.threshold)
    chan0 = getattr(args, "_chan_offset", 0)

    def fin(v, nd):
        # Dead channels give NaN SK; bare NaN is invalid JSON.
        return round(float(v), nd) if np.isfinite(v) else None

    out = {
        "blocks": n,
        "n_chan": cfg.n_chan,
        "m_per_chan": m,
        "sk_median": fin(med, 5),
        "sk_sigma": fin(sigma, 6),
        "threshold": args.threshold,
        "flagged": [chan0 + c for c in flagged],
        "zap": format_zap_spec(chan0 + c for c in flagged),
    }
    if args.sk_values:
        out["sk"] = [fin(v, 5) for v in sk]
    if args.per_ant:
        # Antenna-axis SK: broadband or self-generated RFI localizes to the
        # offending antenna (the --flag-ants analog of --zap).
        m_a = n * sk_samples_per_block(cfg, axis="ant")
        sk_a = sk_estimate(a1, a2, m_a)
        flag_a, med_a, sig_a = sk_flags(sk_a, m_a,
                                        threshold=args.threshold)
        out.update(
            ant_sk_median=fin(med_a, 5),
            ant_sk_sigma=fin(sig_a, 6),
            flagged_ants=flag_a,
            flag_ants=format_zap_spec(flag_a),
        )
        if args.sk_values:
            out["ant_sk"] = [fin(v, 5) for v in sk_a]
    print(json.dumps(out))
    return 0


def cmd_levels(args) -> int:
    """Per-antenna drive-level report from a capture: rms and 4-bit clip
    fraction (operators level-set before science/cal scans).  The
    per-block sums run on ``--device``."""
    from dsabeamformer_tpu_torch.ops.incoherent import wire_level_stats

    scan = _scan_setup(args)
    if scan is None:
        return 2
    cfg, offset = scan
    device = _resolve_device(args)
    if device is None:
        return 2
    rms_acc = None
    clip_acc = None
    n = 0
    for blk in _iter_capture_blocks(args, cfg, offset, device):
        stats = wire_level_stats(blk, cfg)
        rms = _host64(stats["rms"])
        clip = _host64(stats["clip_fraction"])
        rms_acc = rms**2 if rms_acc is None else rms_acc + rms**2
        clip_acc = clip if clip_acc is None else clip_acc + clip
        n += 1
    if n == 0:
        print(f"no blocks in "
              f"{args.input_file or 'ring ' + repr(args.key)}",
              file=sys.stderr)
        return 1
    rms_mean = np.sqrt(rms_acc / n)
    clip_mean = clip_acc / n
    print(json.dumps({
        "blocks": n,
        "n_ant_active": cfg.n_ant_active,
        "rms": [round(float(v), 3) for v in rms_mean],
        "clip_fraction": [round(float(v), 5) for v in clip_mean],
        "worst_clip": round(float(clip_mean.max()), 5),
    }))
    return 0


def cmd_ring(args) -> int:
    """Inspect a live voltage/power ring (the ``dada_dbmonitor`` analog):
    one JSON line of counters, or repeated with ``--watch``."""
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer

    ring = RingBuffer(args.key, connect_timeout_s=args.timeout)
    try:
        while True:
            print(json.dumps({
                "key": args.key,
                "nbufs": ring.nbufs,
                "bufsz": ring.bufsz,
                "written": ring.n_written,
                "read": ring.n_read,
                "backlog": ring.n_written - ring.n_read,
                "dropped": ring.dropped,
                "skipped": ring.skipped,
                "readers": ring.readers,
                "eod": ring.eod(),
            }), flush=True)
            if not args.watch:
                break
            time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    finally:
        ring.close()
    return 0


def cmd_waterfall(args) -> int:
    """ASCII (and optional PGM) time-frequency waterfall of a beam
    product — the quickest "did the observation work" check.  Reads both
    product formats this package writes (.fil and .dada); the legend line
    carries the beam/Stokes/shape provenance so a pasted frame is
    self-describing.  Host NumPy only: no device."""
    from dsabeamformer_tpu_torch.utils.quicklook import (
        dedisperse,
        downsample_mean,
        load_dynamic_spectrum,
        percentile_scale,
        render_ascii,
        write_pgm,
    )

    lo, hi = args.clip
    if not 0.0 <= lo < hi <= 100.0:
        print(f"error: --clip wants 0 <= LO < HI <= 100, got {lo:g} {hi:g}",
              file=sys.stderr)
        return 1
    cand = None
    if args.cand:
        # Vetting flow: pull row --idx from a `dsabf-torch search --cand`
        # file, inherit its DM (and beam, for DADA products), and window
        # the view on the detection so the pulse fills the frame instead
        # of being one column in an hour of data.
        from dsabeamformer_tpu_torch.ops.dedisperse import read_candidates

        try:
            _, cands = read_candidates(args.cand)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not 0 <= args.idx < len(cands):
            print(f"error: --idx {args.idx}: {args.cand} has "
                  f"{len(cands)} candidates", file=sys.stderr)
            return 1
        cand = cands[args.idx]
        if args.dm is None:
            args.dm = cand.dm
        if args.beam is None and cand.beam >= 0:
            args.beam = cand.beam
        print(f"# candidate {args.idx}: snr {cand.snr:g}  "
              f"DM {cand.dm:g}  t_samp {cand.t_samp}  width "
              f"{cand.width}  beam {cand.beam}", file=sys.stderr)
    try:
        meta, x = load_dynamic_spectrum(args.path, beam=args.beam or 0,
                                        stokes=args.stokes)
        if args.dm is not None:
            x = dedisperse(x, meta, args.dm)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if x.shape[0] == 0:
        print("error: product file has no complete blocks", file=sys.stderr)
        return 1
    if cand is not None:
        if cand.t_samp >= x.shape[0]:
            # A t_samp just past the end would still slice a non-empty,
            # pulse-free window that reads as "not real".
            print(f"error: candidate t_samp {cand.t_samp} is beyond "
                  f"this product ({args.path} has {x.shape[0]} "
                  f"samples — wrong file for this .cand?)",
                  file=sys.stderr)
            return 1
        # After dedispersion the pulse sits at its band-top arrival:
        # window +-max(8 widths, half a frame's rows) around t_samp.
        half = max(8 * cand.width, args.rows * 4)
        t0 = max(0, cand.t_samp - half)
        x = x[t0: cand.t_samp + cand.width + half]
    small = downsample_mean(x, args.rows, args.cols)
    frame = render_ascii(percentile_scale(small, lo, hi))
    t, f = x.shape
    band = (f"{meta['f_lo_mhz']:.1f}-{meta['f_hi_mhz']:.1f} MHz"
            if "f_lo_mhz" in meta else "ascending")
    dm_note = f"; DM {args.dm:g}" if args.dm is not None else ""
    print(f"# {args.path}  [{meta['format']}]  beam={meta['beam']}  "
          f"stokes={meta['stokes']}  {t} samples x {f} chans  "
          f"(time down, freq right: {band}; clip {lo:g}-{hi:g}%{dm_note})")
    print(frame)
    if args.dm is not None:
        # Frequency-collapsed time series at this DM (time runs RIGHT
        # here): a pulse at the right DM is one bright char.
        prof = x.mean(axis=1)[None, :]
        prof = downsample_mean(prof.T, args.cols, 1).T
        print(f"# profile(t) @ DM {args.dm:g}: "
              + render_ascii(percentile_scale(prof, lo, hi)))
    if args.out:
        img = x if args.full else small
        write_pgm(args.out, percentile_scale(img, lo, hi))
        print(f"# wrote {args.out} ({img.shape[0]}x{img.shape[1]})",
              file=sys.stderr)
    return 0


def cmd_fold(args) -> int:
    """Fold a beam product at a pulsar period — the known-source
    validation an operator runs after pointing at a catalog pulsar:
    dedisperse at its DM, fold at its period, and the pulse stands up as
    one bright phase row with S/N growing as sqrt(periods folded).  Prints
    the phase-frequency frame, the frequency-collapsed phase profile, and
    a JSON summary (peak S/N, peak phase, periods folded).  Host NumPy
    only: no device."""
    from dsabeamformer_tpu_torch.utils.quicklook import (
        dedisperse,
        downsample_mean,
        fold_spectrogram,
        load_dynamic_spectrum,
        percentile_scale,
        profile_snr,
        render_ascii,
        write_pgm,
    )

    try:
        meta, x = load_dynamic_spectrum(args.path, beam=args.beam,
                                        stokes=args.stokes)
        if x.shape[0] == 0:
            raise ValueError("product file has no complete blocks")
        if args.dm:
            x = dedisperse(x, meta, args.dm)
        if "tsamp_s" not in meta:
            raise ValueError("cannot fold: product header lacks tsamp_s")
        tsamp = float(meta["tsamp_s"])
        prof, counts = fold_spectrogram(x, tsamp, args.period,
                                        n_bins=args.bins)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    snr, peak = profile_snr(prof)
    n_periods = x.shape[0] * tsamp / args.period
    small = downsample_mean(prof, args.bins, args.cols)
    print(f"# {args.path}  beam={meta['beam']}  stokes={meta['stokes']}  "
          f"folded {n_periods:.1f} periods of {args.period:g}s into "
          f"{prof.shape[0]} phase bins x {prof.shape[1]} chans "
          f"(phase down, freq right"
          + (f"; DM {args.dm:g}" if args.dm else "") + ")")
    print(render_ascii(percentile_scale(small, *args.clip)))
    p1 = prof.mean(axis=1)[None, :]
    print("# profile(phase): "
          + render_ascii(percentile_scale(
              downsample_mean(p1.T, args.cols, 1).T, *args.clip)))
    if args.out:
        write_pgm(args.out, percentile_scale(prof, *args.clip))
        print(f"# wrote {args.out} ({prof.shape[0]}x{prof.shape[1]})",
              file=sys.stderr)
    print(json.dumps({
        "period_s": args.period, "dm": args.dm or 0.0,
        "n_bins": prof.shape[0], "n_periods": round(n_periods, 2),
        "peak_bin": peak,
        "peak_phase": round((peak + 0.5) / prof.shape[0], 4),
        "snr": round(snr, 2),
        "min_bin_occupancy": int(counts.min()),
    }))
    return 0


def _search_live_ring(args, device) -> int:
    """``dsabf-torch search --key``: attach to a beamformer's OUTPUT
    product ring and search blocks as they are produced — the reference
    deployment's heimdall-reads-the-DADA-buffer topology, as a separate
    process on the same SearchMonitor the in-process ``run
    --search-dm-max`` uses (same windowing, same banks on ``device``, same
    live coincidence veto).

    ``--key`` takes a comma-separated list to join the one-process-per-
    subband deployment's product rings into ONE full-band live search:
    rings are band-ordered by their header's FREQ_START_HZ, validated
    contiguous, and each step reads one seq-aligned block from every ring
    and concatenates along the channel axis (a ring that dropped a block
    forces the others to skip to the next common seq; the monitor's gap
    logic flushes the sweep buffer, as a single-ring drop does).
    Searching per subband instead would cost DM resolution: the sweep is
    measured ACROSS the band."""
    from dsabeamformer_tpu_torch.ingest import dada
    from dsabeamformer_tpu_torch.ingest.ring import RingBuffer
    from dsabeamformer_tpu_torch.utils.quicklook import (
        _STOKES_INDEX,
        _dada_meta,
    )

    keys = [k.strip() for k in args.key.split(",") if k.strip()]
    if not keys:
        print("error: empty --key", file=sys.stderr)
        return 1
    if len(set(keys)) != len(keys):
        print(f"error: duplicate ring keys in {keys} (two attachments "
              f"to one single-consumer ring interleave reads)",
              file=sys.stderr)
        return 1
    rings = []
    try:
        entries = []  # (f_start, key, ring, hdr, shape)
        payloads = set()
        for key in keys:
            try:
                ring = RingBuffer(key, connect_timeout_s=args.timeout)
            except OSError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            rings.append(ring)
            if ring.readers > 0:
                print(f"[dsabf] WARNING: ring {key!r} already has "
                      f"{ring.readers} attached reader(s) — the ring "
                      f"is single-consumer; both readers will see "
                      f"gaps.", file=sys.stderr)
            try:
                hdr = dada.parse_header(ring.read_header(
                    timeout_s=args.timeout))
            except TimeoutError:
                print(f"error: ring {key!r} has no committed header "
                      f"after {args.timeout:g}s — is the producer "
                      f"(`dsabf-torch run --output-key {key}`) up?",
                      file=sys.stderr)
                return 1
            payload = hdr.get("PAYLOAD", "")
            if payload not in ("BEAM_POWERS", "BEAM_STOKES_IQUV",
                               "INCOHERENT_POWER"):
                print(f"error: ring {key!r} carries "
                      f"PAYLOAD={payload!r}, not a beam product — "
                      f"point --key at `dsabf-torch run --output-key`'s "
                      f"ring, not the voltage capture", file=sys.stderr)
                return 1
            payloads.add(payload)
            shp = [int(hdr["OUT_NCHAN"]), int(hdr["OUT_NTIME"])]
            if payload == "BEAM_STOKES_IQUV":
                shp.append(int(hdr.get("OUT_NSTOKES", 4)))
            if payload != "INCOHERENT_POWER":
                shp.append(int(hdr["OUT_NBEAM"]))
            per_block = int(np.prod(shp)) * 4
            if per_block != ring.bufsz:
                print(f"error: ring {key!r} bufsz {ring.bufsz} != "
                      f"header block size {per_block} (mismatched "
                      f"producer?)", file=sys.stderr)
                return 1
            entries.append((float(hdr.get("FREQ_START_HZ", 0.0)), key,
                            ring, hdr, shp))
        if len(payloads) != 1:
            print(f"error: rings carry mixed payloads {sorted(payloads)}",
                  file=sys.stderr)
            return 1
        payload = payloads.pop()
        inco = payload == "INCOHERENT_POWER"
        entries.sort(key=lambda e: e[0])  # ascending band order
        hdr = entries[0][3]
        if any(e[4][1:] != entries[0][4][1:] for e in entries):
            print(f"error: subband rings disagree beyond the channel "
                  f"axis: {[e[4] for e in entries]}", file=sys.stderr)
            return 1
        # Contiguity: each subband starts where the previous one ended.
        df = float(hdr["BW_HZ"]) / int(hdr["NCHAN_TOTAL"])
        navg_f = int(hdr.get("NAVG_FREQ", 1))
        for (f0, k0, _, _, s0), (f1, k1, _, _, _) in zip(entries,
                                                         entries[1:]):
            if abs(f0 + s0[0] * navg_f * df - f1) > abs(df) * 0.5:
                print(f"error: rings {k0!r} and {k1!r} are not "
                      f"band-contiguous ({f0 + s0[0] * navg_f * df:g} "
                      f"vs {f1:g} Hz)", file=sys.stderr)
                return 1
        shapes = [e[4] for e in entries]
        shape = list(shapes[0])
        shape[0] = sum(s[0] for s in shapes)  # joined channel count
        stokes = payload == "BEAM_STOKES_IQUV"
        if args.stokes != "I" and not stokes:
            print(f"error: no Stokes {args.stokes}: {payload} ring "
                  f"carries no Stokes axis", file=sys.stderr)
            return 1
        s_idx = _STOKES_INDEX[args.stokes]
        meta = _dada_meta(hdr, 0, args.stokes, shape[0])
        try:
            # Beam indices are validated against the ring's own beam
            # count here at attach time, not on the first block.
            mon, dms = _build_search_monitor(
                args, meta, inco, None if inco else shape[-1],
                shape[0], device, src_kind="ring")
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(f"[dsabf] search: attached to {len(entries)} ring(s) "
              f"{[e[1] for e in entries]} ({payload}, joined "
              f"{shape[0]} chan x {shape[1]} samp/block), "
              f"{len(dms)} DM trials [0, {dms[-1]:.1f}], threshold "
              f"{args.threshold:g}", file=sys.stderr)

        def _read_at_least(entry, target):
            """Next block from one ring with seq >= target (stale blocks
            from before a join-skip are consumed and dropped).  A read
            timeout is a WAIT, not the end of the stream — the producer
            may still be warming up or stalled; only EOD (or
            ``--max-idle``) ends the search.  Returns (seq, [F_sub, ...])
            or None at EOD / max-idle."""
            _, key, ring, _, shp = entry
            waited = 0.0
            while True:
                item = ring.read_block(timeout_s=args.timeout)
                if item is None:
                    if ring.eod():
                        return None
                    waited += args.timeout
                    if (args.max_idle is not None
                            and waited >= args.max_idle):
                        print(f"[dsabf] ring {key!r}: no data for "
                              f"{waited:.0f}s (--max-idle) — stopping",
                              file=sys.stderr)
                        return None
                    if waited <= args.timeout:
                        print(f"[dsabf] ring {key!r}: waiting for data "
                              f"(producer warming up or stalled; "
                              f"Ctrl-C or --max-idle bounds the wait)",
                              file=sys.stderr)
                    continue
                seq, raw = item
                if target is None or seq >= target:
                    return seq, raw.view(np.float32).reshape(shp)
                print(f"[dsabf] join: ring {key!r} seq {seq} < "
                      f"common seq {target}, skipped", file=sys.stderr)

        n, skews = 0, 0
        try:
            while args.blocks is None or n < args.blocks:
                # One seq-aligned row across every subband ring: read each
                # at the current common target; a ring that comes back
                # ahead (it dropped the target block) raises the target
                # and the laggards are read again.  Seqs only grow, so
                # this converges.
                target = None
                got = [None] * len(entries)
                ok = True
                while True:
                    for i, e in enumerate(entries):
                        if got[i] is None or (target is not None
                                              and got[i][0] < target):
                            got[i] = _read_at_least(e, target)
                            if got[i] is None:
                                ok = False
                                break
                            if target is None or got[i][0] > target:
                                if target is not None:
                                    skews += 1
                                target = got[i][0]
                    if not ok or all(g[0] == target for g in got):
                        break
                if not ok:
                    break
                block = (got[0][1] if len(got) == 1
                         else np.concatenate([g[1] for g in got], axis=0))
                if inco:
                    mon.observe(target, None, inco=block)
                else:
                    if stokes:  # [F, T, S, B] -> the requested plane
                        block = np.ascontiguousarray(block[:, :, s_idx])
                    mon.observe(target, block)
                n += 1
        except KeyboardInterrupt:
            print("[dsabf] interrupted — flushing search buffer",
                  file=sys.stderr)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        mon.flush()
        _finish_monitor_search(
            mon, f"ring {args.key}", args, meta, dms, n,
            extra_note=f", {skews} subband join skew(s)" if skews else "",
            src_meta={"ring": args.key, "live": True})
        return 0
    finally:
        for ring in rings:
            ring.close()


def _build_search_monitor(args, meta, inco: bool, n_beams, n_chan: int,
                          device, src_kind: str = "product"):
    """Shared head of the monitor-fed search paths (``--key`` ring
    consumer, ``--stream`` file feed): band/cadence-field validation,
    beam-target validation, DM-trial grid, SearchMonitor on ``device``.
    Returns ``(mon, dms)``; raises ValueError with a printable message
    (call sites print ``error: {e}`` and exit 1)."""
    from dsabeamformer_tpu_torch.models.weights import parse_zap
    from dsabeamformer_tpu_torch.ops.dedisperse import (
        DEFAULT_WIDTHS,
        SearchMonitor,
        dm_trial_grid,
    )

    for key in ("f_lo_mhz", "f_hi_mhz", "tsamp_s"):
        if key not in meta:
            raise ValueError(f"cannot search: {src_kind} header lacks "
                             f"the band/cadence fields ({key})")
    try:
        target = _parse_beam_target(args.beam, None if inco else n_beams)
    except ValueError as e:
        raise ValueError(f"bad --beam spec: {e}")
    if inco and target not in ("incoherent", 0):
        raise ValueError(
            f"--beam {args.beam}: this {src_kind} has no beam axis "
            f"(the incoherent product sums all antennas)")
    if target == "incoherent" and not inco:
        raise ValueError(f"--beam incoherent needs an INCOHERENT_POWER "
                         f"{src_kind}")
    tsamp = float(meta["tsamp_s"])
    if args.dm_step:
        dms = np.arange(args.dm_min, args.dm_max + args.dm_step,
                        args.dm_step)
    else:
        dms = dm_trial_grid(meta["f_lo_mhz"], meta["f_hi_mhz"], tsamp,
                            dm_max=args.dm_max, dm_min=args.dm_min,
                            tol=args.dm_tol)
    err = _dm_grid_error(dms, tsamp, args.dm_max)
    if err:
        raise ValueError(err)
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], n_chan)
    mon = SearchMonitor(
        freqs, tsamp, dms, beam=0 if inco else target, incoherent=inco,
        threshold=args.threshold,
        widths=tuple(args.widths) if args.widths else DEFAULT_WIDTHS,
        chunk_t=args.chunk, topk=args.topk,
        zap=parse_zap(args.zap) if args.zap else None,
        zerodm=args.zerodm, method=args.method,
        on_candidate=_emit_search_candidate,
        coincidence=not args.no_coincidence,
        coincidence_frac=args.coincidence_frac,
        on_rfi=_emit_search_rfi, device=device)
    return mon, dms


def _search_device_note(device) -> None:
    """Log the search process's host footprint and its bank kernels'
    launches so far (zero on the CPU, where the plain versions run)."""
    from dsabeamformer_tpu_torch.ops import dedisperse as dd
    from dsabeamformer_tpu_torch.utils.hostenv import process_rss_mb

    launches = {k.__name__: k.launches for k in (
        dd.dedisperse_direct, dd.subband_stage1, dd.subband_stage2)}
    print(f"[dsabf] search on {device}: host RSS {process_rss_mb():.1f} MB, "
          f"bank launches {json.dumps(launches)}", file=sys.stderr)


def _finish_monitor_search(mon, src: str, args, meta, dms, n_blocks,
                           extra_note: str = "", src_meta=None) -> None:
    """Shared tail of the monitor-fed search paths: summary line,
    candidate table, optional .cand file.  Source-specific metadata
    (``live``, ``ring``, ``file``, ``stream``) comes in via
    ``src_meta``."""
    from dsabeamformer_tpu_torch.ops.dedisperse import (
        Candidate,
        write_candidates,
    )

    cands = sorted(mon.candidates, key=lambda c: -c.snr)
    print(f"# {src}: {n_blocks} block(s), "
          f"{mon.searched_windows} window(s), {len(cands)} "
          f"candidate(s)"
          + (f" (+{mon.rfi_rejected} coincidence-rejected RFI)"
             if mon.rfi_rejected else "")
          + (f", {mon.gaps} stream gap(s)" if mon.gaps else "")
          + extra_note, file=sys.stderr)
    _search_device_note(mon.device)
    print(Candidate.HEADER)
    for c in cands[: args.limit]:
        print(c.row())
    if args.cand:
        write_candidates(args.cand, cands, dict(
            src_meta or {}, **_epoch_meta(meta), **{
                "beam": args.beam,
                "tsamp_s": meta["tsamp_s"],
                "f_lo_mhz": meta["f_lo_mhz"],
                "f_hi_mhz": meta["f_hi_mhz"],
                "stokes": args.stokes,
                "n_dm_trials": len(dms), "dm_min": dms[0],
                "dm_max": dms[-1], "threshold": args.threshold,
                "coincidence_rejected": mon.rfi_rejected,
            }))
        print(f"# wrote {args.cand} ({len(cands)} candidates)",
              file=sys.stderr)


def _search_stream_file(args, device) -> int:
    """``dsabf-torch search big.dada --stream``: block-fed offline search
    of ONE DADA product through the SearchMonitor — the product memmap is
    read one block at a time, so peak memory is a block, not the
    observation (a whole-night 256-beam product doesn't fit in host RAM
    as a beam stack).  Coincidence applies per window (the live
    semantics) instead of over the whole run."""
    from dsabeamformer_tpu_torch.ingest.dada import read_product_file
    from dsabeamformer_tpu_torch.utils.quicklook import (
        _STOKES_INDEX,
        _dada_meta,
    )

    path = args.paths[0]
    try:
        hdr, powers = read_product_file(path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if powers.shape[0] == 0:
        print("error: product file has no complete blocks",
              file=sys.stderr)
        return 1
    inco = powers.ndim == 3
    stokes = powers.ndim == 5
    if args.stokes != "I" and not stokes:
        print(f"error: no Stokes {args.stokes}: power-only product",
              file=sys.stderr)
        return 1
    meta = _dada_meta(hdr, 0, args.stokes, powers.shape[1])
    try:
        mon, dms = _build_search_monitor(
            args, meta, inco, None if inco else int(powers.shape[-1]),
            int(powers.shape[1]), device, src_kind="product")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    n = powers.shape[0] if args.blocks is None else min(
        args.blocks, powers.shape[0])
    s_idx = _STOKES_INDEX[args.stokes]
    try:
        for i in range(n):
            blk = powers[i]
            if stokes:
                blk = blk[:, :, s_idx]  # [F, T, B] plane
            if inco:
                mon.observe(i, None, inco=blk)
            else:
                mon.observe(i, np.ascontiguousarray(blk))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    mon.flush()
    _finish_monitor_search(mon, path, args, meta, dms, n,
                           src_meta={"file": path, "stream": True})
    return 0


def cmd_search(args) -> int:
    """Single-pulse search of a beam product over a DM-trial bank on
    ``--device`` (the CUDA banks of ``csrc/dedisperse.cu`` on a card).
    Prints a heimdall-style candidate table; ``--cand`` writes it to a
    file with the search parameters in the comment header.  With ``--key``
    it instead attaches to LIVE output-product ring(s) (see
    `_search_live_ring`)."""
    import torch

    from dsabeamformer_tpu_torch.models.weights import parse_zap
    from dsabeamformer_tpu_torch.ops.dedisperse import (
        DEFAULT_WIDTHS,
        Candidate,
        coincidence_filter,
        delay_table,
        dm_trial_grid,
        search_spectrogram,
        search_spectrograms,
        write_candidates,
    )
    from dsabeamformer_tpu_torch.utils.quicklook import load_dynamic_spectra

    device = _resolve_device(args)
    if device is None:
        return 2
    if not 0 < args.coincidence_frac <= 1:
        # validated BEFORE the search runs, not in the filter after it
        print(f"error: --coincidence-frac must be in (0, 1], got "
              f"{args.coincidence_frac}", file=sys.stderr)
        return 1
    if args.key and args.paths:
        print("error: give product file(s) OR --key, not both",
              file=sys.stderr)
        return 1
    if args.key:
        return _search_live_ring(args, device)
    if not args.paths:
        print("error: need product file(s) or --key", file=sys.stderr)
        return 1
    if args.stream:
        if len(args.paths) != 1:
            print("error: --stream takes ONE DADA product (per-beam "
                  ".fil sets load whole by design)", file=sys.stderr)
            return 1
        return _search_stream_file(args, device)
    # Beam spec: an index, a '3,7,100-110' set, or 'all'.  Several input
    # files (the per-beam .fil layout run --fil-dir writes) each
    # contribute their own beam.
    if args.beam.strip().lower() == "all":
        beams = "all"
    else:
        try:
            beams = parse_zap(args.beam)
        except ValueError as e:
            print(f"error: bad --beam spec: {e}", file=sys.stderr)
            return 1
    spectra = []  # (beam_label, [T, F])
    meta = None
    try:
        for path in args.paths:
            m, pairs = load_dynamic_spectra(path, beams=beams,
                                            stokes=args.stokes)
            if meta is None:
                meta = m
            elif any(abs(m.get(k, 0) - meta.get(k, 1)) > 1e-9
                     for k in ("f_lo_mhz", "f_hi_mhz", "tsamp_s")):
                raise ValueError(
                    f"{path}: band/cadence disagrees with {args.paths[0]} "
                    f"(searching mixed products makes no sense)")
            spectra.extend(pairs)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    labels = [b for b, _ in spectra]
    if len(set(labels)) != len(labels):
        dup = sorted({b for b in labels if labels.count(b) > 1})
        print(f"error: duplicate beam label(s) {dup} across inputs — "
              f"per-beam .fil files must carry distinct ibeam headers "
              f"(dsabf-torch run --fil-dir stamps them)",
              file=sys.stderr)
        return 1
    for key in ("f_lo_mhz", "f_hi_mhz", "tsamp_s"):
        if key not in meta:
            print(f"error: cannot search: product header lacks {key}",
                  file=sys.stderr)
            return 1
    if any(x.shape[0] == 0 for _, x in spectra):
        print("error: product file has no complete blocks", file=sys.stderr)
        return 1
    x = spectra[0][1]
    tsamp = float(meta["tsamp_s"])
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], x.shape[1])
    if args.dm_step:
        dms = np.arange(args.dm_min, args.dm_max + args.dm_step,
                        args.dm_step)
    else:
        dms = dm_trial_grid(meta["f_lo_mhz"], meta["f_hi_mhz"], tsamp,
                            dm_max=args.dm_max, dm_min=args.dm_min,
                            tol=args.dm_tol)
    err = _dm_grid_error(dms, tsamp, args.dm_max)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    widths = (tuple(args.widths) if args.widths else
              tuple(w for w in DEFAULT_WIDTHS if w < x.shape[0]))
    zap_chans = None
    if args.zap:
        try:
            zap_chans = parse_zap(args.zap)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    kw = dict(widths=widths, threshold=args.threshold, chunk_t=args.chunk,
              topk=args.topk, zap=zap_chans, zerodm=args.zerodm,
              method=args.method, device=device)
    t0 = time.perf_counter()
    try:
        if len(spectra) > 1 and len({xb.shape for _, xb in spectra}) == 1:
            # One observation's beams share [T, F]: the beam-batched bank.
            by_beam = search_spectrograms(spectra, freqs, tsamp, dms, **kw)
        else:
            by_beam = {}
            for b, xb in spectra:
                cs = search_spectrogram(xb, freqs, tsamp, dms, **kw)
                for c in cs:
                    c.beam = b
                by_beam[b] = cs
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    n_rfi = 0
    if len(spectra) > 1 and not args.no_coincidence:
        band_span = delay_table(freqs, dms, tsamp).max(axis=1)
        by_beam, rfi_events = coincidence_filter(
            by_beam, band_span, n_beams_searched=len(spectra),
            frac=args.coincidence_frac)
        for ev in rfi_events:
            _emit_search_rfi(ev)
        n_rfi = len(rfi_events)
    cands = sorted((c for cs in by_beam.values() for c in cs),
                   key=lambda c: -c.snr)
    if device.type == "cuda":
        # The candidates are host values already; nothing of the search
        # may still run on the card when the clock stops.
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    span_s = x.shape[0] * tsamp
    src = (args.paths[0] if len(args.paths) == 1
           else f"{len(args.paths)} files")
    print(f"# {src}: {len(spectra)} beam(s) x {x.shape[0]} samples x "
          f"{x.shape[1]} chans ({span_s:.2f} s), {len(dms)} DM trials "
          f"[{dms[0]:g}, {dms[-1]:.1f}] widths {list(widths)} "
          f"thresh {args.threshold:g}  ->  {len(cands)} candidates"
          + (f" (+{n_rfi} coincidence-rejected RFI)" if n_rfi else "")
          + f" in {dt:.2f} s ({len(spectra) * span_s / dt:.1f}x realtime)",
          file=sys.stderr)
    _search_device_note(device)
    print(Candidate.HEADER)
    for c in cands[: args.limit]:
        print(c.row())
    if len(cands) > args.limit:
        print(f"# ... {len(cands) - args.limit} more (raise --limit, "
              f"or see --cand file)")
    if args.cand:
        write_candidates(args.cand, cands, dict(_epoch_meta(meta), **{
            "file": src, "beams": len(spectra),
            "stokes": meta["stokes"], "tsamp_s": tsamp,
            "f_lo_mhz": meta["f_lo_mhz"], "f_hi_mhz": meta["f_hi_mhz"],
            "n_dm_trials": len(dms), "dm_min": dms[0], "dm_max": dms[-1],
            "widths": list(widths), "threshold": args.threshold,
            "coincidence_rejected": n_rfi,
        }))
        print(f"# wrote {args.cand} ({len(cands)} candidates)",
              file=sys.stderr)
    return 0


def cmd_trace(args) -> int:
    """Trace a few block steps on ``--device`` (``torch.profiler``; CUDA
    activity on a card) and print the per-op duration breakdown."""
    from dsabeamformer_tpu_torch.utils.profiling import (
        DEFAULT_LOG_DIR,
        profile_block_step,
    )

    cfg = _load_cfg(args)
    device = _resolve_device(args)
    if device is None:
        return 2
    args.out = args.out or DEFAULT_LOG_DIR
    try:
        rows = profile_block_step(cfg, n_blocks=args.blocks,
                                  log_dir=args.out, device=device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"log_dir": args.out, "blocks": args.blocks,
                      "ops": rows}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dsabf-torch", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="beamform a voltage stream")
    _add_common(p)
    p.add_argument("--key", default="dsa", help="input ring name (DADA-key analog)")
    p.add_argument("--input-file", help="read blocks from a raw file instead")
    p.add_argument("--output-key", help="write powers to an output ring")
    p.add_argument("--output-file", help="append powers to a raw float32 file")
    p.add_argument("--fil-dir",
                   help="write per-beam SIGPROC filterbank files here "
                        "(beamNNNN.fil — the FRB search tools' native "
                        "format)")
    p.add_argument("--fil-beams",
                   help="comma-separated beam indices for --fil-dir "
                        "(default: all beams)")
    p.add_argument("--utc-start",
                   help="observation start (PSRDADA UTC_START string) "
                        "stamped into DADA product headers")
    p.add_argument("--tstart-mjd", type=float, default=0.0,
                   help="observation start MJD stamped into --fil-dir "
                        "headers (tstart) and DADA product headers "
                        "(MJD_START)")
    p.add_argument("--fil-bits", type=int, default=32, choices=[8, 32],
                   help="filterbank sample width; 8 quarters product IO")
    p.add_argument("--fil-scale", default="auto",
                   help="8-bit counts per unit power (default: "
                        "auto-calibrate from the first block's median)")
    p.add_argument("--cal", help="calibration .npz (CalTable)")
    p.add_argument("--layout",
                   help="antenna position table (.npz or text: EW [NS] "
                        "meters, one row per dish)")
    p.add_argument("--weights",
                   help="pre-quantized weights .npz (dsabf-torch weights, "
                        "or dsabf weights)")
    p.add_argument("--zap", metavar="CHANS",
                   help="RFI channel excision: comma-separated FULL-band "
                        "raw channel indices/ranges (e.g. 12,100-110) "
                        "whose weights are zeroed — coherent products "
                        "read exactly 0 there; with --incoherent-file "
                        "the matching averaged groups are masked")
    p.add_argument("--flag-ants", metavar="ANTS",
                   help="bad-antenna excision: comma-separated antenna "
                        "indices/ranges (e.g. 3,17-19) zeroed in the "
                        "weights and excluded from the incoherent sum")
    p.add_argument("--rfi-auto", action="store_true",
                   help="streaming spectral-kurtosis monitor: excise "
                        "channels whose SK leaves the robust null "
                        "mid-run (sticky; weights regenerate through "
                        "the stream's update path)")
    p.add_argument("--rfi-interval", type=int, default=8,
                   help="observed blocks pooled per excision decision")
    p.add_argument("--rfi-sample", type=int, default=1,
                   help="observe every Nth block (unsampled blocks run the "
                        "kernel variant without the SK sums, so sampling "
                        "cuts the monitor's kernel cost to 1/N at the "
                        "price of 1/N the data per excision decision); "
                        "default 1")
    p.add_argument("--rfi-threshold", type=float, default=5.0,
                   help="robust z-score for flagging (dsabf-torch rfi's "
                        "--threshold)")
    p.add_argument("--rfi-max-fraction", type=float, default=0.25,
                   help="refuse to auto-zap beyond this fraction of "
                        "the band (a broken null is not RFI)")
    p.add_argument("--search-dm-max", type=float,
                   help="enable the live single-pulse search up to "
                        "this DM [pc/cm^3] (trial grid auto-spaced "
                        "from the band + cadence; ops/dedisperse.py)")
    p.add_argument("--search-beam", default="0",
                   help="what to search: a beam index, a '3,7,100-110' "
                        "set, 'all', or 'incoherent' for the "
                        "all-antenna sum (sets/'all' search "
                        "beam-batched with live cross-beam "
                        "coincidence RFI rejection)")
    p.add_argument("--search-no-coincidence", action="store_true",
                   help="multi-beam live search: keep candidates that "
                        "fire in many beams at once (default: "
                        "rejected as RFI)")
    p.add_argument("--search-coincidence-frac", type=float, default=0.25,
                   help="fraction of searched beams a linked cluster "
                        "must hit to be tagged RFI (floor: 3 beams)")
    p.add_argument("--search-threshold", type=float, default=7.0,
                   help="matched-filter S/N floor for live candidates")
    p.add_argument("--search-chunk", type=int, default=4096,
                   help="owned output samples per search window "
                        "(windows additionally carry max_delay + "
                        "max_width samples forward)")
    p.add_argument("--search-cand",
                   help="write the run's candidates here at exit "
                        "(heimdall-style columns)")
    p.add_argument("--search-zerodm", action="store_true",
                   help="zero-DM filter the searched spectrogram "
                        "(removes broadband undispersed RFI)")
    p.add_argument("--search-method", default="conv",
                   choices=["conv", "direct", "subband"],
                   help="dedispersion bank: conv (default — the two-stage "
                        "plan of the live path; <=1 extra sample of "
                        "smearing), direct (brute force, exact), or "
                        "subband (the gather two-stage)")
    p.add_argument("--pointing", type=float, default=0.0,
                   help="pointing angle (rad)")
    p.add_argument("--stats-file", help="append per-block JSONL stats here")
    p.add_argument("--trace-blocks", type=int, default=0, metavar="N",
                   help="record a torch.profiler trace of N steady-state "
                        "blocks (from the drain after the first depth+2), "
                        "with the loop's dsabf.* spans, and print its path")
    p.add_argument("--products", default="power",
                   choices=["power", "stokes"],
                   help="detection product: Stokes-I powers or full "
                        "Stokes I/Q/U/V")
    p.add_argument("--incoherent-file",
                   help="also write the incoherent-sum total power per "
                        "block ([F/navg_f, T/navg_t] float32) to this file")
    p.add_argument("--track", action="store_true",
                   help="regenerate weights as the pointing drifts (fringe tracking)")
    p.add_argument("--declination", type=float, default=0.0,
                   help="source declination (rad), sets the drift rate")
    _device_arg(p, "run on this device")
    p.add_argument("--mesh", type=int,
                   help="stream through a channel-sharded mesh of N "
                        "slots: N distinct cards, or with --device N slots "
                        "on that one device")
    p.add_argument("--depth", type=int, default=2, help="blocks in flight")
    p.add_argument("--blocks", type=int, help="stop after N blocks")
    p.add_argument("--latest", action="store_true",
                   help="skip-ahead overrun policy")
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--nbufs", type=int, default=8)
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("simulate", help="synthetic capture producer")
    _add_common(p)
    p.add_argument("--key", default="dsa")
    p.add_argument("--blocks", type=int, default=32)
    p.add_argument("--rate", type=float,
                   help="pace to this real-time factor (default: unthrottled)")
    p.add_argument("--rms", type=float, default=2.0)
    p.add_argument("--source-angle", type=float,
                   help="inject a point source at this angle (deg)")
    p.add_argument("--pulse-dm", type=float,
                   help="inject a dispersed broadband pulse at this DM "
                        "into block 0 (at --source-angle if given; the "
                        "injected-FRB end-to-end drill)")
    p.add_argument("--pulse-t0", type=int, default=0,
                   help="pulse start sample at the top of the band")
    p.add_argument("--pulse-width", type=int, default=16,
                   help="pulse width in raw samples")
    p.add_argument("--pulse-period", type=int,
                   help="make the pulse a PULSAR: a phase-coherent "
                        "periodic train at this period [raw samples] "
                        "across every block (blocks are generated "
                        "per-block)")
    p.add_argument("--distinct", type=int, default=4,
                   help="number of distinct pre-generated blocks")
    p.add_argument("--nbufs", type=int, default=4,
                   help="ring depth; /dev/shm use = nbufs x wire block "
                        "(2.1 GB/block at the dsa10 preset's t_block=8192)")
    p.add_argument("--linger", type=float, default=10.0,
                   help="seconds to wait for the consumer to drain after EOD")
    p.add_argument("--out-file",
                   help="write a DADA capture file instead of a ring")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("weights", help="generate + quantize + save weights")
    _add_common(p)
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--cal", help="calibration .npz (CalTable)")
    p.add_argument("--layout",
                   help="antenna position table (.npz or text: EW [NS] "
                        "meters, one row per dish)")
    p.add_argument("--pointing", type=float, default=0.0)
    p.add_argument("--zap", metavar="CHANS",
                   help="RFI channel excision (see `dsabf-torch run --zap`)")
    p.add_argument("--flag-ants", metavar="ANTS",
                   help="bad-antenna excision (see `dsabf-torch run "
                        "--flag-ants`)")
    _device_arg(p, "make the table on this device")
    p.set_defaults(fn=cmd_weights)

    p = sub.add_parser("beampattern", help="render the formed-beam response")
    _add_common(p)
    p.add_argument("--out", required=True, help="output image path (.png)")
    p.add_argument("--sweep", type=int, default=512, help="sweep points")
    _device_arg(p, "compute the response on this device")
    p.set_defaults(fn=cmd_beampattern)

    p = sub.add_parser("selftest", help="end-to-end correctness check")
    _add_common(p)
    _device_arg(p, "run on this device")
    p.set_defaults(fn=cmd_selftest, config="tiny")

    p = sub.add_parser("info", help="device + config diagnostics")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench",
                       help="single-device benchmark (JSON line)")
    _add_common(p)
    p.add_argument("--blocks", type=int, default=16)
    p.add_argument("--bench-mode", default="kernel",
                   choices=["stream", "kernel"],
                   help="kernel (default) = device-resident launch loop, "
                        "the device's per-block capability; stream = "
                        "end-to-end host-to-device ingest, which measures "
                        "the host's staging and copies too")
    _device_arg(p, "benchmark this device")
    p.set_defaults(fn=cmd_bench)

    def _scan_input(p, default_ring_blocks=8):
        # A capture file or a live ring; ring mode defaults to a bounded
        # block count so the command ends.
        p.add_argument("--input-file", help="capture file (raw or DADA)")
        p.add_argument("--key", help="scan a LIVE ring instead")
        p.add_argument("--timeout", type=float, default=5.0,
                       help="ring attach/read timeout (s)")
        p.add_argument("--blocks", type=int,
                       help=f"use at most N blocks (ring mode "
                            f"defaults to {default_ring_blocks})")
        _device_arg(p, "sum each block on this device")

    p = sub.add_parser("calibrate",
                       help="solve antenna gains from a calibrator "
                            "capture or live ring")
    _add_common(p)
    _scan_input(p)
    p.add_argument("--angle", type=float, required=True,
                   help="calibrator angle (deg, east of boresight)")
    p.add_argument("--out", required=True, help="output CalTable .npz")
    p.add_argument("--ref-ant", type=int, default=0,
                   help="reference antenna (phase zero point)")
    p.add_argument("--layout",
                   help="antenna position table (.npz or text)")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("levels",
                       help="per-antenna rms + clip report from a "
                            "capture or live ring")
    _add_common(p)
    _scan_input(p)
    p.set_defaults(fn=cmd_levels)

    p = sub.add_parser(
        "rfi",
        help="spectral-kurtosis RFI scan (capture or live ring) -> "
             "--zap spec")
    _add_common(p)
    _scan_input(p)
    p.add_argument("--threshold", type=float, default=5.0,
                   help="robust z-score beyond which a channel is "
                        "flagged (null = cross-channel median/MAD)")
    p.add_argument("--sk-values", action="store_true",
                   help="include the full per-channel SK vector")
    p.add_argument("--per-ant", action="store_true",
                   help="also resolve SK per ANTENNA and emit a "
                        "--flag-ants spec")
    p.set_defaults(fn=cmd_rfi)

    p = sub.add_parser(
        "launch",
        help="spawn N per-subband `dsabf-torch run` processes (deployment "
             "supervisor; {i}/{n} template in forwarded args)")
    p.add_argument("--subbands", type=int, required=True,
                   help="number of equal subbands / child processes")
    p.add_argument("--devices",
                   help="comma-separated device per subband, each a card "
                        "index or cpu (a card may repeat)")
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="arguments forwarded to each `dsabf-torch run` "
                        "child (prefix with --)")
    p.set_defaults(fn=cmd_launch)

    p = sub.add_parser("fil",
                       help="inspect a SIGPROC filterbank product (JSON)")
    p.add_argument("path", help="beamNNNN.fil file from --fil-dir")
    p.set_defaults(fn=cmd_fil)

    p = sub.add_parser(
        "splice",
        help="merge per-subband .fil products into one full-band file")
    p.add_argument("inputs", nargs="+",
                   help="per-subband beamNNNN.fil files (any order)")
    p.add_argument("--out", required=True, help="merged output .fil")
    p.set_defaults(fn=cmd_splice)

    p = sub.add_parser("trace", help="capture + summarize a device trace")
    _add_common(p)
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--out",
                   help="trace directory (a .trace.json.gz for Perfetto "
                        "or chrome://tracing; default dsabf-trace in the "
                        "temporary directory)")
    _device_arg(p, "trace on this device")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "waterfall",
        help="quick-look time-frequency waterfall of a product file")
    p.add_argument("path", help=".fil or .dada beam-product file")
    p.add_argument("--beam", type=int, default=None,
                   help="beam index (DADA products; .fil files are "
                        "already per-beam; default 0, or the "
                        "candidate's beam with --cand)")
    p.add_argument("--stokes", default="I", choices=list("IQUV"),
                   help="Stokes plane for nifs=4 / Stokes products")
    p.add_argument("--cand", help="a `dsabf-torch search --cand` file: vet "
                                  "one of its rows — inherits the "
                                  "row's DM/beam and windows the view "
                                  "on the detection")
    p.add_argument("--idx", type=int, default=0,
                   help="candidate row to vet (0 = brightest; rows "
                        "are SNR-sorted)")
    p.add_argument("--rows", type=int, default=32,
                   help="terminal rows (time bins)")
    p.add_argument("--cols", type=int, default=78,
                   help="terminal columns (frequency bins)")
    p.add_argument("--clip", type=float, nargs=2, default=(1.0, 99.0),
                   metavar=("LO", "HI"),
                   help="contrast percentiles (robust to RFI pixels)")
    p.add_argument("--dm", type=float,
                   help="incoherently dedisperse at this DM (pc/cm^3) "
                        "before rendering, and append the collapsed "
                        "time profile — the known-pulsar/FRB check")
    p.add_argument("--out", help="also write an 8-bit PGM image "
                                 "(downsampled to --rows x --cols "
                                 "unless --full)")
    p.add_argument("--full", action="store_true",
                   help="PGM at native resolution (no downsample)")
    p.set_defaults(fn=cmd_waterfall)

    p = sub.add_parser(
        "fold",
        help="fold a product at a pulsar period (known-source check)")
    p.add_argument("path", help=".fil or .dada beam-product file")
    p.add_argument("--period", type=float, required=True,
                   help="fold period [s] (the catalog pulsar's)")
    p.add_argument("--dm", type=float, default=0.0,
                   help="dedisperse at this DM [pc/cm^3] before folding")
    p.add_argument("--beam", type=int, default=0,
                   help="beam index (DADA products)")
    p.add_argument("--stokes", default="I", choices=list("IQUV"),
                   help="Stokes plane for Stokes products")
    p.add_argument("--bins", type=int, default=64,
                   help="phase bins (capped at period/tsamp)")
    p.add_argument("--cols", type=int, default=78,
                   help="terminal columns (frequency bins)")
    p.add_argument("--clip", type=float, nargs=2, default=(1.0, 99.0),
                   metavar=("LO", "HI"),
                   help="contrast percentiles")
    p.add_argument("--out", help="also write the [bins, F] profile as "
                                 "an 8-bit PGM image")
    p.set_defaults(fn=cmd_fold)

    p = sub.add_parser(
        "search",
        help="single-pulse search of a product over a DM-trial bank")
    p.add_argument("paths", nargs="*", metavar="path",
                   help=".fil or .dada beam-product file(s) — multiple "
                        "per-beam .fil files search together with "
                        "cross-beam coincidence RFI rejection")
    p.add_argument("--key", help="search LIVE output-product ring(s) "
                                 "(`dsabf-torch run --output-key`) "
                                 "instead of files — the separate-process "
                                 "search-consumer deployment; a "
                                 "comma-separated list joins the "
                                 "per-subband deployment's rings into "
                                 "one full-band search (band-ordered, "
                                 "contiguity-checked, seq-aligned)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="ring attach timeout / read poll interval (s)")
    p.add_argument("--max-idle", type=float,
                   help="give up after this many seconds without data "
                        "(default: wait until end-of-data — a producer "
                        "warms up for seconds)")
    p.add_argument("--stream", action="store_true",
                   help="feed ONE DADA product block-by-block through "
                        "the streaming monitor instead of loading it "
                        "whole — bounded memory for whole-night "
                        "products (coincidence applies per window)")
    p.add_argument("--blocks", type=int,
                   help="stop after N ring blocks (default: until "
                        "end-of-data)")
    p.add_argument("--beam", default="0",
                   help="beams to search in DADA products: an index, "
                        "a '3,7,100-110' set, or 'all' (multi-beam "
                        "searches get coincidence RFI rejection)")
    p.add_argument("--stokes", default="I", choices=list("IQUV"),
                   help="Stokes plane to search (usually I)")
    p.add_argument("--dm-min", type=float, default=0.0)
    p.add_argument("--dm-max", type=float, default=1000.0,
                   help="top of the DM-trial range [pc/cm^3]")
    p.add_argument("--dm-step", type=float,
                   help="fixed trial spacing (default: auto from "
                        "--dm-tol and the band/cadence)")
    p.add_argument("--dm-tol", type=float, default=1.25,
                   help="auto-grid spacing in output samples of "
                        "band-edge differential delay per trial")
    p.add_argument("--threshold", type=float, default=7.0,
                   help="matched-filter S/N floor")
    p.add_argument("--widths", type=int, nargs="+",
                   help="boxcar widths in output samples "
                        "(default 1 2 4 8 16 32)")
    p.add_argument("--chunk", type=int, default=16384,
                   help="host-side chunk length [output samples]")
    p.add_argument("--topk", type=int, default=4,
                   help="peaks kept per (width, trial) per chunk")
    p.add_argument("--limit", type=int, default=20,
                   help="candidate rows printed (file gets all)")
    p.add_argument("--cand", help="write a candidate file (heimdall-"
                                  "style columns, '#' header)")
    p.add_argument("--zap",
                   help="PRODUCT channels to neutralize before the "
                        "search, e.g. '12,100-110' (dsabf-torch rfi's "
                        "output frame divided by navg_freq)")
    p.add_argument("--zerodm", action="store_true",
                   help="subtract each sample's cross-channel mean "
                        "(classic zero-DM filter: removes broadband "
                        "undispersed RFI, costs ~1/F of pulse power)")
    p.add_argument("--method", default="direct",
                   choices=["conv", "direct", "subband"],
                   help="dedispersion bank: brute-force (exact; the "
                        "offline default), two-stage subband gather, "
                        "or conv (the two-stage plan the live monitor "
                        "uses — <=1 extra sample of smearing)")
    p.add_argument("--no-coincidence", action="store_true",
                   help="keep candidates that fire in many beams at "
                        "once (default: they are RFI — a sky pulse is "
                        "localized, sidelobe RFI is everywhere)")
    p.add_argument("--coincidence-frac", type=float, default=0.25,
                   help="fraction of searched beams a linked cluster "
                        "must hit to be tagged RFI (floor: 3 beams)")
    _device_arg(p, "search on this device")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("ring", help="inspect a ring's counters (JSON)")
    p.add_argument("--key", default="dsa")
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--watch", type=float,
                   help="re-print every N seconds until Ctrl-C")
    p.set_defaults(fn=cmd_ring)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # `dsabf-torch ... | head` closing the pipe is normal use, not an
        # error: no traceback, and none at shutdown on the closed stdout.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
