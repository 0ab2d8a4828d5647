"""The share of the traced window, in percent, in which no kernel, copy or
memset ran on the card."""


def read(run, out):
    return 100.0 * (1.0 - out.trace.busy_s() / out.trace.window_s)
