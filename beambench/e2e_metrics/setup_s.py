"""Process start to the window's start: imports, the card, the kernel's
build or load, the inputs, the weights, the warm-up and any pre-roll."""


def read(run, out):
    return out.setup_s
