"""Sky seconds of the blocks drained to the sinks inside the window, over
the window's seconds: the whole window's work over its whole time."""


def read(run, out):
    if not out.drains:
        return None
    return out.drained_in_window() * run.block_s / (out.t1 - out.t0)
