"""Prompt tokens prefilled per second of the window: the tokens of every
completed call (the entry's work, B x S a call), over the host time from
the window's start to the end of its last call, tracing off. A call ends
with its logits on the host."""


def read(run):
    if not run.calls:
        return None
    done = sum(c.work for c in run.calls)
    return done / (run.calls[-1].end - run.calls[0].start)
