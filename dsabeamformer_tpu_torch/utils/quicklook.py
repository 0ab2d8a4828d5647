"""Quick-look waterfall rendering for beam products (`dsabf-torch waterfall`).

The operator's first question about any product file — "did the
observation work?" — is answered by eyeballing a time-frequency
waterfall: RFI shows as bright channels, a dropped antenna as a level
step, a slewed beam as a fringe pattern.  The reference ecosystem does
this with sigproc/presto plotters; a quick-look with ZERO extra
dependencies belongs in the package itself (SURVEY.md §2 C11 analysis
tooling), reading both product formats this framework writes:

- SIGPROC filterbank (``dsabf-torch run --fil-dir``; `ingest/sigproc.py`)
- DADA beam-product files (``dsabf-torch run --output-file x.dada``;
  `ingest/dada.py:read_product_file`)

Rendering is host-side numpy only: block-mean downsample to the
terminal/image grid, robust percentile contrast (RFI-tolerant: a 1%
bright fraction must not flatten the rest of the image), then an ASCII
luminance ramp for the terminal or a binary 8-bit PGM (P5) for files —
PGM because it needs no imaging library and every viewer/converter
understands it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dsabeamformer_tpu_torch.config import DM_CONST_S, dm_delays_s

__all__ = [
    "load_dynamic_spectrum",
    "load_dynamic_spectra",
    "dedisperse",
    "fold_spectrogram",
    "profile_snr",
    "downsample_mean",
    "percentile_scale",
    "render_ascii",
    "write_pgm",
    "DM_CONST_S",
]

# Dark -> bright luminance ramp (10 levels reads fine on any terminal).
ASCII_RAMP = " .:-=+*#%@"

_STOKES_INDEX = {"I": 0, "Q": 1, "U": 2, "V": 3}


def load_dynamic_spectrum(
    path: str | Path, beam: int = 0, stokes: str = "I"
) -> Tuple[Dict, np.ndarray]:
    """Load one beam's dynamic spectrum ``[T, F]`` (float64, time
    forward, frequency ASCENDING) from either product format, sniffed
    by magic: SIGPROC files start with the HEADER_START keyword block,
    DADA files with an ASCII header.

    Both formats come back in the same channel orientation (``.fil``
    files store descending frequency and are flipped here) so the two
    renderings of one observation agree — an RFI channel sits at the
    same edge either way.

    Returns ``(meta, ts_by_chan)``; ``meta`` carries the format's own
    header plus ``format``, ``beam``, ``stokes``, and — when the
    header gives the band — ``f_lo_mhz``/``f_hi_mhz`` channel-center
    edges.  ``stokes`` selects the IF plane for Stokes products
    (power-only files reject Q/U/V requests).
    """
    path = Path(path)
    if stokes not in _STOKES_INDEX:
        raise ValueError(f"stokes must be one of {list(_STOKES_INDEX)}, "
                         f"got {stokes!r}")
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == (12).to_bytes(4, "little") and head[4:16] == b"HEADER_START":
        from dsabeamformer_tpu_torch.ingest.sigproc import read_filterbank

        hdr, data = read_filterbank(path)  # [T, nifs, F]
        nifs = int(hdr.get("nifs", 1))
        if stokes != "I" and nifs != 4:
            raise ValueError(f"file has nifs={nifs}, no Stokes {stokes} "
                             f"(power-only product)")
        s = _STOKES_INDEX[stokes] if nifs == 4 else 0
        x = data[:, s, :].astype(np.float64)
        meta = dict(hdr, format="sigproc", beam=int(hdr.get("ibeam", beam)),
                    stokes=stokes)
        if "tsamp" in hdr:
            meta["tsamp_s"] = float(hdr["tsamp"])
        fch1, foff = hdr.get("fch1"), hdr.get("foff")
        if fch1 is not None and foff is not None:
            edges = (fch1, fch1 + foff * (x.shape[1] - 1))
            meta["f_lo_mhz"], meta["f_hi_mhz"] = min(edges), max(edges)
        if foff is not None and foff < 0:
            x = x[:, ::-1]  # file is descending; normalize to ascending
        return meta, x
    from dsabeamformer_tpu_torch.ingest.dada import read_product_file

    hdr, powers = read_product_file(path)
    x, beam_label = _dada_extract(hdr, powers, beam, stokes)
    return _dada_meta(hdr, beam_label, stokes, x.shape[1]), x


def _dada_extract(hdr, powers, beam, stokes: str, dtype=np.float64):
    """One beam's time-contiguous ``[T_total, F]`` (``dtype``) from a
    loaded DADA product payload: ``[n_blocks, F, T, B]``,
    ``[n_blocks, F, T, 4, B]`` (Stokes), or ``[n_blocks, F, T]``
    (incoherent — no beam axis); channels already ascending."""
    if powers.ndim == 3:  # incoherent total power: no beam axis
        if stokes != "I":
            raise ValueError(f"no Stokes {stokes}: {hdr.get('PAYLOAD')} is "
                             f"a power-only product")
        if beam != 0:
            raise ValueError(
                f"beam {beam}: {hdr.get('PAYLOAD')} has no beam axis "
                f"(the incoherent product sums all antennas)")
        x = powers
        beam_label = "incoherent"
    else:
        n_beams = powers.shape[-1]
        if not 0 <= beam < n_beams:
            raise ValueError(f"beam {beam} out of range (file has {n_beams})")
        if powers.ndim == 5:
            x = powers[:, :, :, _STOKES_INDEX[stokes], beam]
        elif stokes != "I":
            raise ValueError(f"no Stokes {stokes}: {hdr.get('PAYLOAD')} is "
                             f"a power-only product")
        else:
            x = powers[..., beam]
        beam_label = beam
    # [n_blocks, F, T] -> time-contiguous [T_total, F]
    x = np.ascontiguousarray(
        x.transpose(0, 2, 1).reshape(-1, x.shape[1])
    ).astype(dtype)
    return x, beam_label


def _dada_meta(hdr, beam_label, stokes: str, nchan_out: int) -> Dict:
    meta = dict(hdr, format="dada", beam=beam_label, stokes=stokes)
    try:
        f0 = float(hdr["FREQ_START_HZ"])
        df = float(hdr["BW_HZ"]) / int(hdr["NCHAN_TOTAL"])
        navg = int(hdr.get("NAVG_FREQ", 1))
        # averaged-channel centers, ascending
        meta["f_lo_mhz"] = (f0 + df * navg * 0.5) / 1e6
        meta["f_hi_mhz"] = (f0 + df * navg * (nchan_out - 0.5)) / 1e6
        # output cadence: critically-sampled channel period x time avg
        meta["tsamp_s"] = (int(hdr["NCHAN_TOTAL"]) / float(hdr["BW_HZ"])
                           * int(hdr.get("NAVG_TIME", 1)))
    except (KeyError, ValueError):
        pass
    return meta


def load_dynamic_spectra(
    path: str | Path, beams="all", stokes: str = "I"
):
    """Multi-beam variant of :func:`load_dynamic_spectrum`: ONE file
    read, then ``(meta, [(beam, x), ...])`` for the requested beams —
    what the multi-beam search (`dsabf-torch search --beam all`) wants,
    since re-reading a 256-beam product per beam would dominate the
    search itself.

    ``beams`` is ``"all"`` or an iterable of indices.  SIGPROC files
    are single-beam products: the selection is ignored and the file
    contributes its own ``ibeam`` (matching `load_dynamic_spectrum`,
    whose ``beam`` argument never applied to ``.fil`` files either).

    Arrays come back **float32** (the products' native dtype and what
    the search stage consumes) — at 256 beams a float64 copy per beam
    would triple the peak host footprint for no precision gain.
    """
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(16)
    if head[:4] == (12).to_bytes(4, "little") and head[4:16] == b"HEADER_START":
        meta, x = load_dynamic_spectrum(path, stokes=stokes)
        return meta, [(meta["beam"], x.astype(np.float32))]
    from dsabeamformer_tpu_torch.ingest.dada import read_product_file

    hdr, powers = read_product_file(path)
    if powers.ndim == 3:
        if beams != "all" and list(beams) != [0]:
            raise ValueError(
                f"beams {list(beams)}: {hdr.get('PAYLOAD')} has no "
                f"beam axis (the incoherent product sums all antennas)")
        idx = [0]
    else:
        n_beams = powers.shape[-1]
        idx = list(range(n_beams)) if beams == "all" else [
            int(b) for b in beams]
    out = []
    meta = None
    for b in idx:
        x, label = _dada_extract(hdr, powers, b, stokes,
                                 dtype=np.float32)
        if meta is None:
            meta = _dada_meta(hdr, label, stokes, x.shape[1])
        out.append((label if isinstance(label, int) else 0, x))
    return meta, out


def dedisperse(x: np.ndarray, meta: Dict, dm: float) -> np.ndarray:
    """Incoherent dedispersion of an ascending-frequency ``[T, F]``
    dynamic spectrum: each channel is advanced by the cold-plasma
    delay ``DM_CONST_S * DM * (f_c^-2 - f_hi^-2)`` relative to the top
    of the band, rounded to output samples — a pulse dispersed at
    ``dm`` lines up vertically in the rendered waterfall (the standard
    known-pulsar/FRB sanity check; the search stage proper does this
    over thousands of trial DMs).

    Vacated trailing samples are filled with the channel median
    (neutral gray in the rendering, unlike zeros which would paint a
    false dark wedge).  Requires ``meta`` to carry the band edges and
    ``tsamp_s`` (both product formats provide them).
    """
    for key in ("f_lo_mhz", "f_hi_mhz", "tsamp_s"):
        if key not in meta:
            raise ValueError(
                f"cannot dedisperse: product header lacks {key}")
    if dm < 0:
        raise ValueError(f"DM must be >= 0, got {dm}")
    t, nf = x.shape
    freqs = np.linspace(meta["f_lo_mhz"], meta["f_hi_mhz"], nf)
    delays = dm_delays_s(freqs, dm, meta["f_hi_mhz"])
    shifts = np.rint(delays / meta["tsamp_s"]).astype(np.int64)
    out = np.empty_like(x)
    shifted = [int(c) for c in np.nonzero(shifts)[0]]
    unshifted = shifts == 0
    out[:, unshifted] = x[:, unshifted]
    if shifted:
        # One vectorized median pass for the fill values (a Python
        # per-channel median loop is the scan's cost at real sizes).
        fills = np.median(x[:, shifted], axis=0)
        for fill, c in zip(fills, shifted):
            s = shifts[c]
            if s >= t:
                out[:, c] = fill
            else:
                out[: t - s, c] = x[s:, c]
                out[t - s :, c] = fill
    return out


def fold_spectrogram(
    x: np.ndarray, tsamp_s: float, period_s: float, n_bins: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold ``[T, F]`` at ``period_s`` into a ``[n_bins, F]``
    phase-frequency MEAN profile — the known-pulsar validation: fold a
    beam product at the pulsar's period and the pulse appears as one
    bright phase row, with S/N growing as sqrt(n_periods).

    Returns ``(profile, counts)``; ``counts[b]`` is the number of
    samples folded into phase bin ``b`` (uneven by at most one period's
    worth — report it rather than hiding the ragged tail).  Phase 0 is
    the first sample of the product.
    """
    t, _ = x.shape
    if period_s <= tsamp_s:
        raise ValueError(f"period {period_s:g}s must exceed the sample "
                         f"time {tsamp_s:g}s")
    if n_bins < 2:
        raise ValueError(f"n_bins must be >= 2, got {n_bins}")
    if t * tsamp_s < 2 * period_s:
        raise ValueError(
            f"product spans {t * tsamp_s:.3f}s < 2 periods "
            f"({period_s:g}s) — nothing to fold")
    eff_bins = min(n_bins, max(2, int(period_s / tsamp_s)))
    phase = (np.arange(t, dtype=np.float64) * tsamp_s / period_s) % 1.0
    b = np.minimum((phase * eff_bins).astype(np.int64), eff_bins - 1)
    counts = np.bincount(b, minlength=eff_bins)
    prof = np.zeros((eff_bins, x.shape[1]), np.float64)
    np.add.at(prof, b, np.asarray(x, np.float64))
    prof /= np.maximum(counts, 1)[:, None]
    return prof, counts


def profile_snr(prof: np.ndarray,
                off_frac: float = 0.5) -> Tuple[float, int]:
    """Peak S/N of a folded frequency-collapsed profile against its
    quietest ``off_frac`` of phase bins (robust off-pulse baseline:
    mean/std over the bins least likely to contain the pulse).
    Sigma is measured ON the folded bins, so unequal bin occupancy
    (`fold_spectrogram`'s ragged last period, at most one period's
    worth) is already baked into the estimate — no per-bin
    reweighting.  Returns ``(snr, peak_bin)``."""
    p = prof.mean(axis=1)
    order = np.argsort(p)
    n_off = max(2, int(off_frac * p.size))
    off = p[order[:n_off]]
    base, sigma = float(off.mean()), float(off.std())
    if sigma == 0:
        sigma = 1e-30
    peak = int(np.argmax(p))
    return float((p[peak] - base) / sigma), peak


def downsample_mean(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Block-mean ``[T, F]`` down to ``[<=rows, <=cols]``.

    Bin edges come from an even split of each axis (the last bin
    absorbs the remainder), so every input pixel lands in exactly one
    output cell — a dropout or RFI spike dims/brightens its cell
    instead of vanishing to subsampling.  Axes already <= target are
    left at native resolution.
    """
    if x.ndim != 2:
        raise ValueError(f"expected [T, F], got shape {x.shape}")
    t, f = x.shape
    if t == 0 or f == 0:
        raise ValueError(f"empty dynamic spectrum {x.shape}")

    def _bins(n: int, k: int) -> np.ndarray:
        k = min(n, k)
        return np.linspace(0, n, k + 1).astype(np.int64)

    tb, fb = _bins(t, rows), _bins(f, cols)
    # Two-stage add.reduceat keeps this O(T*F) with no Python loop.
    s = np.add.reduceat(x, tb[:-1], axis=0)
    s = np.add.reduceat(s, fb[:-1], axis=1)
    counts = np.diff(tb)[:, None] * np.diff(fb)[None, :]
    return s / counts


def percentile_scale(x: np.ndarray, lo: float = 1.0, hi: float = 99.0
                     ) -> np.ndarray:
    """Map to [0, 1] with percentile clipping: the contrast window is
    the [lo, hi] percentile range, so a few saturated RFI pixels can't
    flatten the rest of the image.  Constant input renders mid-gray
    (0.5) rather than dividing by zero; NaN/inf pixels clip to the
    window edges."""
    finite = x[np.isfinite(x)]
    if finite.size == 0:
        return np.full(x.shape, 0.5)
    p_lo, p_hi = np.percentile(finite, [lo, hi])
    if p_hi <= p_lo:
        return np.full(x.shape, 0.5)
    y = (x - p_lo) / (p_hi - p_lo)
    return np.clip(np.nan_to_num(y, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)


def render_ascii(scaled: np.ndarray, ramp: str = ASCII_RAMP) -> str:
    """[rows, cols] in [0, 1] -> one terminal frame, time running DOWN
    (first row = start of observation), one char per cell."""
    idx = np.minimum((scaled * len(ramp)).astype(np.int64), len(ramp) - 1)
    lut = np.array(list(ramp))
    return "\n".join("".join(row) for row in lut[idx])


def write_pgm(path: str | Path, scaled: np.ndarray) -> None:
    """Binary 8-bit PGM (P5): universally readable without an imaging
    dependency.  Same orientation as the ASCII frame."""
    g = np.round(scaled * 255).astype(np.uint8)
    h, w = g.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode("ascii"))
        f.write(g.tobytes())
