"""Share, in %, of the device time of the profiled calls that latent
attention takes: the device operations launched while the host was inside
one of the program's `model.mla` spans (`repro_torch.spans`: each MLA
layer's projections, latent norm, RoPE, the latent written, k and v
expanded, attention and the output projection) over every device
operation of the calls. Nothing on a program without such spans."""
import bisect

from portbench.program_spans import records


def read(run):
    spans = records(run, "model.mla")
    tr = run.trace
    if spans is None or not tr.device_ops:
        return None
    starts = [s for _, s, _, _, _ in spans]
    ends = [e for _, _, e, _, _ in spans]
    mla = 0
    for _, s, e, launch in tr.device_ops:
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch < ends[i]:
            mla += e - s
    if not mla:
        return None
    return 100.0 * mla / sum(e - s for _, s, e, _ in tr.device_ops)
