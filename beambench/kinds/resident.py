"""The card alone: the deployed detect call back to back on resident blocks.

A pool of ``pool_blocks`` distinct blocks made on the device from the seed;
``ops.gemm.beamform_power`` with the deployed side outputs (uint8 epilogue
at the 8-bit sink's scales, incoherent sum, SK accumulators) on block
``i % pool`` for as long as the window lasts, the host at most two calls
ahead of the card, and the window closed by ``torch.cuda.synchronize()``.
The check's sample is drawn from the seed over every call of the window
(reservoir sampling): its outputs are kept as they are, no copy.
"""

from __future__ import annotations

import collections
import time

import torch

from beambench import inputs, program
from beambench.core import Kept, Outcome, Run
from beambench.trace import Tracer
from dsabeamformer_tpu_torch.ops import gemm

#: The products of the deployed detect call (``products/<name>.py``), in
#: the order it returns them.
OWN = ("uint8", "incoherent", "sk")


def run(r: Run) -> Outcome:
    dev = r.device
    cuda = dev.type == "cuda"
    if extra := program.require_products(r.mix, OWN):
        raise ValueError(f"the resident kind makes {list(OWN)} only, the mix "
                         f"also asks for {extra}")
    cfg = program.obs_config(r.config, r.control)
    tracer = Tracer(r.trace, dev)
    qw = program.port_weights(cfg, inputs.steering_weights(r.config, r.seed,
                                                           dev))
    n_pool = int(r.mix["pool_blocks"])
    pool = [inputs.wire_block(r.config, r.seed, k, dev).reshape(
        cfg.device_wire_shape) for k in range(n_pool)]
    sink = program.KeepSink(cfg, (), tracer.span)
    scales = sink.calibrate(pool[0], qw)

    def call(i):
        return gemm.beamform_power(pool[i % n_pool], qw, cfg, incoherent=True,
                                   sk_stats=True, quant8_scales=scales)

    call(0)  # the window's variant, built and warm
    if cuda:
        torch.cuda.synchronize(dev)
    tracer.prepare()
    n_keep = int(r.mix["check_blocks"])
    pick = r.rng(1)
    kept: list = []
    ahead: collections.deque = collections.deque()
    lead, length = r.trace_window
    trace_first = trace_last = 0
    launches0 = sum(gemm.fused_detect.launches.values())
    i = 0
    t0 = time.perf_counter()
    t_end = t0 + r.seconds
    while (now := time.perf_counter()) < t_end:
        if tracer.enabled:
            if tracer.t_open is None and now >= t0 + lead:
                tracer.open()
                trace_first = i
            elif tracer.active and now >= tracer.t_open + length:
                tracer.close()
                trace_last = i
        with tracer.span("resident.launch"):
            outs = call(i)
        if i < n_keep:
            kept.append((i, outs))
        else:
            j = int(pick.integers(0, i + 1))
            if j < n_keep:
                kept[j] = (i, outs)
        del outs
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ahead.append(ev)
            if len(ahead) > 2:
                with tracer.span("resident.wait"):
                    ahead.popleft().synchronize()
        i += 1
    if cuda:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if tracer.active:
        tracer.close()
        trace_last = i
    tracer.finish()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = sum(gemm.fused_detect.launches.values()) - launches0
    out = Outcome(
        t0=t0, t1=t1, setup_s=t0 - r.t_process, attempted=i, failed=0,
        kept=[Kept(content=k % n_pool, products={
                  name: t.cpu().numpy() for name, t in zip(OWN, outs)})
              for k, outs in sorted(kept, key=lambda kv: kv[0])],
        memory_peak_bytes=int(memory_peak), completed=i,
        scales=sink.scale_vector())
    del kept, pool, qw, scales
    if r.trace:
        out.trace = tracer.view()
        out.trace_blocks = trace_last - trace_first
    out.notes = {"pool_blocks": n_pool, "kernel_launches": launches}
    if r.trace:
        out.notes["trace_open_ms"] = tracer.open_ms
    return out
