"""The host's time in the search a window, in ms: the program's
``dsabf.search.window`` spans in the traced window over the windows
completed there (``dsabf.search.cluster`` spans, one a window).  Beside it
on standard error: the split into ``dsabf.search.bank``, ``.topk`` and
``.cluster``, and the share of the device's busy time inside
``dsabf.search.window`` spans, the device's times put on the host's clock
(``spans.ProgramSpans.skew``).  Nothing where the trace holds no window."""

import sys

from beambench.spans import ProgramSpans

WINDOW = "dsabf.search.window"
PARTS = ("dsabf.search.bank", "dsabf.search.topk", "dsabf.search.cluster")


def _inside(ps, name) -> list:
    v = ps.view
    return [s for s in ps.named(name) if v.t0 <= s.a and s.b <= v.t1]


def busy_share(ps) -> float:
    """Share of the device's busy time in the window inside window spans."""
    spans = sorted((s.a, s.b) for s in ps.named(WINDOW))
    busy = inside = 0.0
    for a, b in ps.view.busy_intervals():
        shift = ps.skew((a + b) / 2)
        a, b = a + shift, b + shift
        busy += b - a
        for sa, sb in spans:
            if sb <= a:
                continue
            if sa >= b:
                break
            inside += min(b, sb) - max(a, sa)
    return inside / busy if busy else 0.0


def read(run, out):
    ps = ProgramSpans(out.trace)
    windows = len(_inside(ps, PARTS[2]))
    if not windows:
        return None
    ms = sum(s.b - s.a for s in _inside(ps, WINDOW)) / 1e3 / windows
    split = {p.rsplit(".", 1)[1]: round(sum(s.b - s.a for s in
                                            _inside(ps, p)) / 1e3 / windows,
                                        3) for p in PARTS}
    print(f"beambench: search_window_ms {ms:.3f} over {windows} window(s), "
          f"a window's ms {split}, device busy inside window spans "
          f"{100 * busy_share(ps):.2f}%", file=sys.stderr)
    return ms
