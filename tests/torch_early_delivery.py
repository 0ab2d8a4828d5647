"""Fakes that drive the streaming loop's early delivery on the CPU: a
source that answers "nothing yet" to a number of polls before each block,
and a stream whose blocks finish on cue, counted in those polls.

The CPU route has no D2H copies to poll, so ``OnCue`` injects
``StreamingBeamformer._done``: block ``seq`` counts as finished once the
source has been polled ``finish[seq]`` times since the block was read.
Everything else (the products, the retire point, the RFI monitor's poll)
is the CPU route's own.
"""

from __future__ import annotations

import dsabeamformer_tpu_torch.pipeline as ppipe


class PacedSource:
    """Blocks ``0 .. n - 1`` of ``blocks`` (cycled); ``poll_block``
    answers None to the first ``waits(seq)`` polls before block ``seq``
    (none before block 0) and at the end, as a ring answers at end of
    data.  ``log`` holds ``("read", seq)`` as each block is handed over,
    ``("end",)`` when ``read_block`` ends the stream; ``polls`` counts every
    poll."""

    pinned = False
    dropped = skipped = 0

    def __init__(self, blocks, n, waits=lambda seq: 3, log=None):
        self.blocks = blocks
        self.n = n
        self.waits = waits
        self.log = [] if log is None else log
        self.polls = 0
        self._i = 0
        self._left = 0

    def poll_block(self, timeout_s):
        self.polls += 1
        if self._i >= self.n or self._left > 0:
            self._left -= 1
            return None
        return self._next()

    def read_block(self):
        if self._i >= self.n:
            self.log.append(("end",))
            return None
        return self._next()

    def _next(self):
        seq = self._i
        self._i += 1
        self._left = self.waits(seq + 1)
        self.log.append(("read", seq))
        return seq, self.blocks[seq % len(self.blocks)]


class OnCue(ppipe.StreamingBeamformer):
    """A CPU stream whose block ``seq`` finishes ``finish(seq)`` polls of
    ``source`` after it was read (``finish`` None: the loop cannot tell,
    as on the CPU route).  Deliveries go to ``source.log`` as
    ``("deliver", seq)``."""

    def __init__(self, *args, finish=lambda seq: 1, **kw):
        super().__init__(*args, **kw)
        self.finish = finish
        self._read_at: dict = {}
        user = self.on_block

        def on_block(bs):
            self.source.log.append(("deliver", bs.seq))
            if user is not None:
                user(bs)

        self.on_block = on_block

    def _read(self):
        item, spent = super()._read()
        if item is not None:
            self._read_at[item[0]] = self.source.polls
        return item, spent

    def _done(self, seq, pending):
        after = self.finish(seq)
        if after is None:
            return None
        return self.source.polls - self._read_at[seq] >= after
