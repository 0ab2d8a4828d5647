"""SIGPROC filterbank output: the search stage's native on-disk format.

The port of ``dsabeamformer_tpu/ingest/sigproc.py``: the header encoder and
reader, the per-beam ``FilterbankSink`` (power or full Stokes; 32-bit, or
8-bit with a per-beam scale), and the subband splice.  The headers are
byte for byte the JAX package's, so files from either package read in the
other and splice together.

Format (SIGPROC's ``filterbank`` flavor):

- header: ``<i32 len><ascii keyword>`` tokens with little-endian binary
  values (int32 / float64), bracketed by ``HEADER_START`` / ``HEADER_END``;
  the payload follows immediately.
- payload: time-major samples, each ``[nifs, nchans]`` float32 (``nbits=32``)
  or uint8 (``nbits=8``); ``nifs=1`` for power, ``nifs=4`` for full Stokes
  (I, Q, U, V: SIGPROC's IF axis).
- channels are written in DESCENDING frequency (``fch1`` = highest averaged
  channel centre, ``foff`` < 0), the convention dedispersion tools assume;
  the writer flips the channel axis.

The 8-bit quantizer runs where the product is: in the detection kernel's
epilogue (``fused_quant8_scales``, the streaming path), on the device as
torch ops (``device_post``, for ``navg_freq > 1``), or on the host for a
float32 block.  All three compute ``clip(rint(x * scale_b), 0, 255)``; an
8-bit Stokes file adds ``STOKES_QUV_OFFSET`` to its signed Q/U/V planes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dsabeamformer_tpu_torch.config import ObsConfig
from dsabeamformer_tpu_torch.ops.gemm import (
    STOKES_QUV_OFFSET,
    quantize_u8,
    stokes_offsets,
)
from dsabeamformer_tpu_torch.utils.device import resolve_device

__all__ = ["encode_filterbank_header", "FilterbankSink", "read_filterbank",
           "read_filterbank_header", "splice_filterbanks",
           "STOKES_QUV_OFFSET"]


def _kw(keyword: str) -> bytes:
    b = keyword.encode("ascii")
    return struct.pack("<i", len(b)) + b


def _kw_int(keyword: str, v: int) -> bytes:
    return _kw(keyword) + struct.pack("<i", int(v))


def _kw_dbl(keyword: str, v: float) -> bytes:
    return _kw(keyword) + struct.pack("<d", float(v))


def _kw_str(keyword: str, v: str) -> bytes:
    return _kw(keyword) + _kw(v)


def _avg_freqs_mhz(cfg: ObsConfig) -> np.ndarray:
    """Centre frequencies (MHz) of the navg_freq-averaged output channels,
    ascending: the mean of each averaged group's raw centres."""
    f = cfg.freqs_hz().reshape(cfg.n_chan // cfg.navg_freq, cfg.navg_freq)
    return f.mean(axis=1) / 1e6


def encode_filterbank_header(
    cfg: ObsConfig,
    *,
    beam: int,
    nifs: int = 1,
    nbits: int = 32,
    tstart_mjd: float = 0.0,
    source_name: str = "DSABF",
    telescope_id: int = 0,
    machine_id: int = 0,
) -> bytes:
    """SIGPROC filterbank header for one beam of this config's output.

    ``ibeam``/``nbeams`` record the fan position; ``az_start`` carries the
    beam's fan angle (degrees east of boresight); ``tsamp`` is the averaged
    output cadence; ``fch1``/``foff`` describe the descending channel order
    the sink writes.
    """
    favg = _avg_freqs_mhz(cfg)
    foff = -(cfg.bandwidth_hz / cfg.n_chan_total * cfg.navg_freq) / 1e6
    return b"".join([
        _kw("HEADER_START"),
        _kw_str("source_name", source_name),
        _kw_int("telescope_id", telescope_id),
        _kw_int("machine_id", machine_id),
        _kw_int("data_type", 1),  # 1 = filterbank
        _kw_dbl("fch1", favg[-1]),  # highest averaged centre first
        _kw_dbl("foff", foff),
        _kw_int("nchans", len(favg)),
        _kw_int("nbits", nbits),
        _kw_int("nifs", nifs),
        _kw_dbl("tstart", tstart_mjd),
        _kw_dbl("tsamp", cfg.sample_period_s * cfg.navg_time),
        _kw_int("ibeam", beam),
        _kw_int("nbeams", cfg.n_beams),
        _kw_dbl("src_raj", 0.0),
        _kw_dbl("src_dej", 0.0),
        _kw_dbl("az_start",
                float(np.rad2deg(cfg.beam_angles_rad()[beam]))),
        _kw_dbl("za_start", 0.0),
        _kw("HEADER_END"),
    ])


class FilterbankSink:
    """Per-beam SIGPROC ``.fil`` writer with the pipeline sink API
    (``write(seq, block)`` / ``close()``).

    ``block`` is the product the stream fetched: ``[F', T', B]`` for power,
    ``[F', T', 4, B]`` for Stokes, float32, or uint8 when it was quantized
    on the device (``F' = n_chan/navg_freq``, ``T' = t_block/navg_time``).
    Each selected beam appends ``T'`` samples of ``[nifs, F']`` with the
    channel axis flipped to descending frequency.

    ``nbits=8`` writes ``clip(rint(x * scale), 0, 255)`` uint8.  SIGPROC has
    no per-block scale field, so a file's scale is constant;
    ``scale="auto"`` calibrates per beam from the beam's first block (its
    median mapped to mid-rail 64) and keeps it.  The scales in effect are
    written to ``<dir>/scales.json`` on close, the only durable record of
    the counts-per-unit-power calibration.

    8-bit Stokes (``products="stokes"``, nifs=4) stores the signed Q/U/V
    planes at the fixed midpoint ``STOKES_QUV_OFFSET`` (recorded in the
    sidecar as ``__quv_offset__``): ``counts = x * scale + offset``, with I
    at offset 0 so intensity-only consumers read it as a power file.  The
    auto scale comes from the I plane (``|Q|, |U|, |V| <= I`` per sample).

    Gaps in ``seq`` (dropped or skipped blocks) are zero-filled so the
    file's time axis stays contiguous for dedispersion;
    ``n_splices`` / ``filled_samples`` count what was filled.

    The streaming loop (``StreamingBeamformer``) hands the block through
    ``device_layout`` first: the selected beams, beam-major with channels
    descending (``layout_shape``), made on the device, so each beam's file
    gets one contiguous slab and the host does no transpose; it then writes
    with ``write_beams``.  The bytes written are the same either way.
    """

    def __init__(
        self,
        dir_path: str | Path,
        cfg: ObsConfig,
        beams: Optional[Sequence[int]] = None,
        products: str = "power",
        tstart_mjd: float = 0.0,
        source_name: str = "DSABF",
        nbits: int = 32,
        scale: float | str = "auto",
    ):
        if products not in ("power", "stokes"):
            raise ValueError(f"unknown products {products!r}")
        if nbits not in (8, 32):
            raise ValueError(f"nbits must be 8 or 32, got {nbits}")
        self.cfg = cfg
        self._stokes = products == "stokes"
        self.nifs = 4 if self._stokes else 1
        self.nbits = nbits
        explicit = None if scale == "auto" else float(scale)
        if nbits == 8 and explicit is not None and explicit <= 0:
            raise ValueError("scale must be positive")
        self.beams = (list(range(cfg.n_beams)) if beams is None
                      else sorted(set(int(b) for b in beams)))
        bad = [b for b in self.beams if not 0 <= b < cfg.n_beams]
        if bad:
            raise ValueError(
                f"beam indices {bad} out of range [0, {cfg.n_beams})")
        self._scales: Dict[int, Optional[float]] = {
            b: explicit for b in self.beams}
        self._dev_scales: Dict[torch.device, torch.Tensor] = {}
        f_out, t_out, _ = cfg.out_block_shape
        #: Shape of a block after ``device_layout``: [beams, T', F'], or
        #: [beams, T', 4, F'] for Stokes.
        self.layout_shape = (len(self.beams), t_out) \
            + ((4,) if self._stokes else ()) + (f_out,)
        self._last_seq: Optional[int] = None
        self.n_splices = 0
        self.filled_samples = 0
        d = Path(dir_path)
        d.mkdir(parents=True, exist_ok=True)
        self._dir = d
        self._files = {}
        for b in self.beams:
            f = open(d / f"beam{b:04d}.fil", "wb")
            f.write(encode_filterbank_header(
                cfg, beam=b, nifs=self.nifs, nbits=nbits,
                tstart_mjd=tstart_mjd, source_name=source_name))
            self._files[b] = f

    @property
    def scales(self) -> Dict[int, Optional[float]]:
        """Per-beam 8-bit counts-per-unit-power scales in effect (None for a
        beam until auto-calibration has seen its first block; empty at
        32-bit)."""
        return dict(self._scales) if self.nbits == 8 else {}

    def device_post(self, out_dev, *, warmup: bool = False):
        """Pipeline hook: quantize the product to uint8 on its device once
        the per-beam scales are known (Stokes Q/U/V at their midpoint), so
        the D2H copy carries 1 byte per sample instead of 4.  Returns
        ``out_dev`` unchanged at nbits=32 or while auto-calibration still
        needs a float32 block; ``warmup=True`` runs the quantizer once with
        unit scales."""
        if self.nbits != 8:
            return out_dev
        if warmup:
            s = torch.ones(out_dev.shape[-1], dtype=torch.float32,
                           device=out_dev.device)
        else:
            s = self._device_scale_vec(out_dev.shape[-1], out_dev.device)
            if s is None:
                return out_dev
        return quantize_u8(out_dev, s, stokes_offsets(out_dev.device)
                           if self._stokes else None)

    def device_layout(self, out_dev):
        """``[F', T', B]`` (power) or ``[F', T', 4, B]`` (Stokes) product,
        float32 or uint8 -> the file layout ``[selected beams, T', F']`` or
        ``[selected beams, T', 4, F']`` with channels descending,
        contiguous, on the product's device; ``write_beams`` takes it."""
        if len(self.beams) != out_dev.shape[-1]:
            out_dev = out_dev[..., self.beams]
        if self._stokes:
            return out_dev.permute(3, 1, 2, 0).flip(3).contiguous()
        return out_dev.permute(2, 1, 0).flip(2).contiguous()

    def fused_quant8_scales(self, device="cuda"):
        """Per-beam scale vector on ``device`` for the kernel's uint8
        epilogue (``quant8_scales`` of ``beamform_power`` and
        ``beamform_stokes``), or None while auto-calibration still needs a
        float32 block, and at nbits=32.
        The bytes are the same as ``device_post``'s; the float32 product
        then never reaches device memory."""
        if self.nbits != 8:
            return None
        return self._device_scale_vec(self.cfg.n_beams, resolve_device(device))

    def _device_scale_vec(self, n_beams: int, device: torch.device):
        """``[n_beams]`` float32 scale vector on ``device``, or None until
        every selected beam's scale is known (unselected beams get 1.0;
        their values are never written).  Made once per device, on the
        current stream."""
        vec = self._dev_scales.get(device)
        if vec is None:
            if any(self._scales[b] is None for b in self.beams):
                return None
            host = np.ones(n_beams, np.float32)
            for b, s in self._scales.items():
                host[b] = s
            vec = self._dev_scales[device] = torch.from_numpy(host).to(device)
        return vec

    def write(self, seq: int, block) -> None:
        """Append one ``[F', T', B]`` / ``[F', T', 4, B]`` block (the
        product's layout)."""
        # -> per-beam [T', F'] / [T', 4, F'] views, channels descending.
        order = (3, 1, 2, 0) if self._stokes else (2, 1, 0)
        view = np.transpose(np.asarray(block), order)[..., ::-1]
        self.write_beams(seq, [view[b] for b in self.beams])

    def write_beams(self, seq: int, slabs) -> None:
        """Append one block given as the selected beams' ``[T', F']`` (power)
        or ``[T', 4, F']`` (Stokes) slabs, channels descending
        (``device_layout``'s form): float32, or uint8 already scaled and
        clipped on the device."""
        pre_quantized = slabs[0].dtype == np.uint8
        t_out = slabs[0].shape[0]
        if self._last_seq is not None and seq > self._last_seq + 1:
            # Stream gap: zero-fill to keep the time axis contiguous.
            gap = (seq - self._last_seq - 1) * t_out
            fill = np.zeros((gap,) + slabs[0].shape[1:],
                            dtype=np.uint8 if self.nbits == 8 else np.float32)
            for f in self._files.values():
                f.write(fill)
            self.n_splices += 1
            self.filled_samples += gap
        self._last_seq = seq
        for out, (b, f) in zip(slabs, self._files.items()):
            if not pre_quantized:
                out = out.astype(np.float32, copy=False)
            if self.nbits == 8 and not pre_quantized:
                if self._scales[b] is None:
                    # Stokes calibrates on the I plane: it bounds the others.
                    med = float(np.median(out[:, 0] if self._stokes
                                          else out))
                    self._scales[b] = 64.0 / med if med > 0 else 1.0
                out = out * np.float32(self._scales[b])
                if self._stokes:
                    # A rounding of its own, as in the JAX package's host
                    # path (its device paths round once, as quantize_u8).
                    out = out + stokes_offsets().numpy()[:, None]
                out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
            # One contiguous copy at most, no tobytes() duplicate.
            f.write(np.ascontiguousarray(out))

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        if self.nbits == 8:
            rec = {f"beam{b:04d}.fil": s for b, s in self._scales.items()}
            if self._stokes:
                # counts = x * scale + offset (I: 0; Q/U/V: the midpoint).
                rec["__quv_offset__"] = STOKES_QUV_OFFSET
            (self._dir / "scales.json").write_text(
                json.dumps(rec, indent=0) + "\n")


def _encode_header_dict(hdr: Dict) -> bytes:
    """SIGPROC header bytes from a parsed header dict (the splice re-emits
    a merged header; the field set mirrors ``encode_filterbank_header``)."""
    return b"".join([
        _kw("HEADER_START"),
        _kw_str("source_name", str(hdr.get("source_name", "DSABF"))),
        _kw_int("telescope_id", int(hdr.get("telescope_id", 0))),
        _kw_int("machine_id", int(hdr.get("machine_id", 0))),
        _kw_int("data_type", int(hdr.get("data_type", 1))),
        _kw_dbl("fch1", float(hdr["fch1"])),
        _kw_dbl("foff", float(hdr["foff"])),
        _kw_int("nchans", int(hdr["nchans"])),
        _kw_int("nbits", int(hdr.get("nbits", 32))),
        _kw_int("nifs", int(hdr.get("nifs", 1))),
        _kw_dbl("tstart", float(hdr.get("tstart", 0.0))),
        _kw_dbl("tsamp", float(hdr["tsamp"])),
        _kw_int("ibeam", int(hdr.get("ibeam", 0))),
        _kw_int("nbeams", int(hdr.get("nbeams", 1))),
        _kw_dbl("src_raj", float(hdr.get("src_raj", 0.0))),
        _kw_dbl("src_dej", float(hdr.get("src_dej", 0.0))),
        _kw_dbl("az_start", float(hdr.get("az_start", 0.0))),
        _kw_dbl("za_start", float(hdr.get("za_start", 0.0))),
        _kw("HEADER_END"),
    ])


def read_filterbank_header(path: str | Path) -> Tuple[Dict, int]:
    """Parse only the SIGPROC header -> (header dict, payload offset)."""
    ints = {"telescope_id", "machine_id", "data_type", "nchans", "nbits",
            "nifs", "ibeam", "nbeams", "barycentric", "pulsarcentric"}
    dbls = {"fch1", "foff", "tstart", "tsamp", "src_raj", "src_dej",
            "az_start", "za_start", "refdm", "period"}
    strs = {"source_name", "rawdatafile"}
    hdr: Dict = {}
    with open(path, "rb") as f:
        def rd(n: int) -> bytes:
            b = f.read(n)
            if len(b) != n:
                raise ValueError(
                    f"truncated SIGPROC header (wanted {n} bytes, "
                    f"got {len(b)})")
            return b

        def rd_kw() -> str:
            (n,) = struct.unpack("<i", rd(4))
            if not 0 < n < 64:
                raise ValueError(f"bad SIGPROC keyword length {n}")
            return rd(n).decode("ascii")

        if rd_kw() != "HEADER_START":
            raise ValueError("not a SIGPROC filterbank file")
        while True:
            kw = rd_kw()
            if kw == "HEADER_END":
                break
            if kw in ints:
                (hdr[kw],) = struct.unpack("<i", rd(4))
            elif kw in dbls:
                (hdr[kw],) = struct.unpack("<d", rd(8))
            elif kw in strs:
                hdr[kw] = rd_kw()
            else:
                raise ValueError(f"unknown SIGPROC keyword {kw!r}")
        nbits = hdr.get("nbits", 32)
        if nbits not in (8, 32):
            raise ValueError(f"only nbits 8/32 payloads supported, "
                             f"got {nbits}")
        return hdr, f.tell()


def read_filterbank(path: str | Path) -> Tuple[Dict, np.ndarray]:
    """Parse a SIGPROC filterbank file -> (header dict, data ``[T, nifs,
    nchans]`` in the file's descending channel order; float32 for nbits=32,
    uint8 raw counts for nbits=8)."""
    hdr, off = read_filterbank_header(path)
    nbits = hdr.get("nbits", 32)
    with open(path, "rb") as f:
        f.seek(off)
        data = np.frombuffer(
            f.read(), dtype=np.uint8 if nbits == 8 else np.float32)
    nifs, nchans = hdr.get("nifs", 1), hdr["nchans"]
    return hdr, data.reshape(-1, nifs, nchans)


def _read_sidecar(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def splice_filterbanks(paths, out_path: str | Path,
                       chunk_samples: int = 4096) -> Dict:
    """Merge per-subband ``.fil`` files into one full-band file.

    Files may come in any order; they are sorted by frequency and must tile
    the band contiguously with identical tsamp/tstart/nifs/nbits/beam.
    Payloads are memory-mapped and spliced in bounded chunks.  Returns the
    merged header.  Samples beyond the shortest file are dropped, counted in
    ``_dropped_samples``.  For 8-bit inputs ``_subband_scales`` is None when
    every subband used one scale (carried into the output's scales.json),
    else the list of scales (None for a missing sidecar), for the caller to
    warn about a stepped bandpass.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("cannot splice: no input files given")
    out_res = Path(out_path).resolve()
    metas = []
    for p in paths:
        if Path(p).resolve() == out_res:
            raise ValueError(f"cannot splice: --out {out_path} is also "
                             f"an input")
        hdr, off = read_filterbank_header(p)
        metas.append((hdr, off, Path(p)))
    defaults = {"tstart": 0.0, "nifs": 1, "nbits": 32, "ibeam": 0}
    for k in ("tsamp", "tstart", "nifs", "nbits", "foff", "ibeam"):
        vals = {m[0].get(k, defaults.get(k)) for m in metas}
        if len(vals) != 1:
            raise ValueError(f"cannot splice: {k} differs across inputs "
                             f"({sorted(map(str, vals))})")
    foff = metas[0][0]["foff"]
    if foff == 0:
        raise ValueError("cannot splice: foff is 0 (no channel axis)")
    metas.sort(key=lambda m: m[0]["fch1"], reverse=foff < 0)
    h0 = metas[0][0]
    nbits = h0.get("nbits", 32)
    itemsize = 1 if nbits == 8 else 4
    nifs = h0.get("nifs", 1)
    for (ha, _, pa), (hb, _, pb) in zip(metas, metas[1:]):
        expect = ha["fch1"] + ha["nchans"] * ha["foff"]
        if abs(hb["fch1"] - expect) > 1e-6 * abs(ha["foff"]) + 1e-9:
            raise ValueError(
                f"cannot splice: {pb.name} starts at {hb['fch1']} MHz, "
                f"expected {expect} MHz after {pa.name} (bands must "
                f"tile contiguously)")
    if nbits == 8:
        scales = [_read_sidecar(p.parent / "scales.json").get(p.name)
                  for _, _, p in metas]
        if None not in scales:
            lo, hi = min(scales), max(scales)
            merged_scales = scales if hi > lo * 1.01 else None
        else:
            merged_scales = scales
    maps = []
    n_samps = []
    for hdr, off, p in metas:
        row = hdr.get("nifs", 1) * hdr["nchans"]
        n = (p.stat().st_size - off) // (row * itemsize)
        n_samps.append(n)
        maps.append(np.memmap(p, dtype=np.uint8 if nbits == 8
                              else np.float32, mode="r", offset=off,
                              shape=(n, nifs, hdr["nchans"])))
    t_out = min(n_samps)
    merged = dict(h0, nchans=sum(m[0]["nchans"] for m in metas))
    with open(out_path, "wb") as f:
        f.write(_encode_header_dict(merged))
        for t0 in range(0, t_out, chunk_samples):
            t1 = min(t0 + chunk_samples, t_out)
            f.write(np.ascontiguousarray(np.concatenate(
                [m[t0:t1] for m in maps], axis=2)))
    merged["_dropped_samples"] = int(max(n_samps) - t_out)
    merged["_n_samples"] = int(t_out)
    if nbits == 8:
        merged["_subband_scales"] = merged_scales
        if merged_scales is None:
            # One scale throughout: carry the calibration into the output
            # directory's sidecar, merging with what is there.
            out_p = Path(out_path)
            side_p = out_p.parent / "scales.json"
            rec = _read_sidecar(side_p)
            rec[out_p.name] = scales[0]
            for _, _, p in metas:
                src = _read_sidecar(p.parent / "scales.json")
                if "__quv_offset__" in src:
                    rec["__quv_offset__"] = src["__quv_offset__"]
            side_p.write_text(json.dumps(rec, indent=0) + "\n")
    return merged
