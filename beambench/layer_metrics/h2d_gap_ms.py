"""The mean gap on the copy stream from one wire-block H2D copy's end to
the next one's start, in the traced window: the host's serialized release
of the ring slot, the next open and the enqueue."""

from beambench.layer_metrics.h2d_gbps import _wire_bytes


def read(run, out):
    copies = out.trace.h2d_copies(_wire_bytes(run.config["obs"]))
    gaps = [float(b["ts"]) - (float(a["ts"]) + float(a["dur"]))
            for a, b in zip(copies, copies[1:])]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e3
