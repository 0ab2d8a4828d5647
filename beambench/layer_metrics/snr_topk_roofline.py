"""The search's top-k kernel's share of its roofline, in percent: the least
time of the ``snr_topk_kernel`` launches in the traced window
(``search_work.topk_least_s``, each launch's beams read from its grid: a
block a trial series, ``beams * n_dm`` of them) over their device time
there.  Not reported on a card without a peak, nor where the kernel did not
run."""

from beambench import search_work

KERNEL = "snr_topk_kernel"


def read(run, out):
    peak = search_work.peak_for(run.device_kind)
    if peak is None or "search" not in run.config:
        return None
    least = search_work.topk_least_s(run.config, peak)
    n_dm = search_work.plan(run.config)["n_dm"]
    v = out.trace
    need = spent = 0.0
    for e in v.kernels:
        if KERNEL in e.get("name", "") and v.t0 <= float(e["ts"]) < v.t1:
            grid = e.get("args", {}).get("grid") or [0, 1, 1]
            need += least * grid[0] / n_dm
            spent += float(e["dur"]) / 1e6
    if spent <= 0:
        return None
    return 100.0 * need / spent
