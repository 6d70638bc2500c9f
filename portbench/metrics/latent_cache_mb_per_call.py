"""Megabytes (1e6 B) of latent cache a call writes: the summed `bytes` of
the program's `model.mla` spans in the profiled calls (each MLA layer's
latent and rotated k_pe of every prompt token, from their shapes), per
call. Nothing on a program without such spans."""
from portbench.program_spans import records


def read(run):
    spans = records(run, "model.mla")
    if spans is None or not any("bytes" in a for *_, a in spans):
        return None
    return sum(a.get("bytes", 0) for *_, a in spans) / len(
        run.trace.calls) / 1e6
