"""The wire's host-to-device rate: bytes of the wire-block copies in the
traced window over the summed device time of those copies, in GB/s."""


def _wire_bytes(obs):
    return obs["t_block"] * obs["n_chan"] * obs["n_pol"] * obs["n_ant"]


def read(run, out):
    copies = out.trace.h2d_copies(_wire_bytes(run.config["obs"]))
    dur_us = sum(float(e["dur"]) for e in copies)
    if not copies or dur_us <= 0:
        return None
    return sum(int(e["args"]["bytes"]) for e in copies) / (dur_us * 1e-6) / 1e9
