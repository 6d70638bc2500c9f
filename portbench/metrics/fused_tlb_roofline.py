"""The fused TLB rounds' share of their roofline, in %: the least time of
each round's work (`work.round_work_rows`, counted in a replay of the
first profiled call, whose rounds get the same inputs) over the rounds'
device time in that call. Nothing when the two do not pair up round for
round."""
from portbench import work
from portbench.entries._sim import ROUND


def read(run):
    tr = run.trace
    done = None if tr is None else tr.extra.get("round_work")
    if not done:
        return None
    cs, ce = tr.calls[0]
    if tr.on_device:
        rounds = [(s, e) for n, s, e, _ in tr.device_ops
                  if "fused_tlb" in n and cs <= s < ce]
    else:
        rounds = [(s, e) for s, e in tr.spans(ROUND) if cs <= s < ce]
    if len(rounds) != len(done):
        return None
    least_ms = sum(work.least_time(b, o)[0] for b, o in done)
    took_ms = sum(e - s for s, e in rounds) / 1e6
    return 100.0 * least_ms / took_ms
