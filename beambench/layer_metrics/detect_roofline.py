"""The detect step's share of its roofline, in percent: the least time a
block's product needs on this card (``work.least_time_s``: the larger of
its MACs at the dense int8 peak and its bytes at the memory bandwidth) over
the device time of every CUDA kernel in the traced window, whatever its
name, per block completed there.  Not reported on a card without a peak."""

from beambench import peaks, work


def read(run, out):
    peak = peaks.peak_for(run.device_kind)
    if peak is None or out.trace_blocks <= 0:
        return None
    least_s, _bound = work.least_time_s(run.config["obs"], peak)
    per_block = out.trace.kernel_s() / out.trace_blocks
    return 100.0 * least_s / per_block
