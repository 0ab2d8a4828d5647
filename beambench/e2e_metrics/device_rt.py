"""Sky seconds of the blocks whose products the card completed inside the
window (closed by ``torch.cuda.synchronize()``), over the window's
seconds."""


def read(run, out):
    if not out.completed:
        return None
    return out.completed * run.block_s / (out.t1 - out.t0)
