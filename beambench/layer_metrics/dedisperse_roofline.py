"""The search bank's share of its roofline, in percent: the least time of
the stage-1 and stage-2 launches of the ``conv`` plan in the traced window
(``search_work.least_time_s``, each launch's beams read from its grid:
stage 1 launches ``beams * G`` blocks deep, stage 2 ``beams``) over their
device time there.  The kernels are found by name in the trace
(``bank_kernel``, ``stage2_kernel`` of ``csrc/dedisperse.cu``).  Not
reported on a card without a peak, nor where no bank kernel ran."""

from beambench import search_work

STAGE1, STAGE2 = "bank_kernel", "stage2_kernel"


def read(run, out):
    peak = search_work.peak_for(run.device_kind)
    if peak is None or "search" not in run.config:
        return None
    least = search_work.least_time_s(run.config, peak)
    g = search_work.plan(run.config)["G"]
    v = out.trace
    need = spent = 0.0
    for e in v.kernels:
        if not v.t0 <= float(e["ts"]) < v.t1:
            continue
        name = e.get("name", "")
        z = (e.get("args", {}).get("grid") or [1, 1, 1])[2]
        if STAGE1 in name:
            need += least["stage1"] * z / g
        elif STAGE2 in name:
            need += least["stage2"] * z
        else:
            continue
        spent += float(e["dur"]) / 1e6
    if spent <= 0:
        return None
    return 100.0 * need / spent
