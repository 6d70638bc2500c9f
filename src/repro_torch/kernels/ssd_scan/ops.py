"""Public SSD ops, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version (`ref.py`); any other
device goes to the CUDA kernel (`kernel.py`), which launches or raises.
Nothing falls back from one to the other.

The kernel is reached through ctypes, so its outputs carry no `grad_fn`
of their own. On the card `ssd_intra_chunk` therefore runs it inside
`SsdIntraChunk`, an autograd Function whose forward is the kernel and
whose backward differentiates the plain version on the saved inputs.
The reference has no backward kernel either: it trains through XLA's
gradient of the plain math.

DTensor inputs (a sharded model, `distributed/sharding.py`) run on each
rank's local shards (`kernels/_dtensor.run_local`), the kernel inside
`SsdIntraChunk` on the card as above: `ssd_scan` whole (the inter-chunk
recurrence too: batch and heads are independent through it), sharded by
batch and heads (B and C whole over the head shards), and
`ssd_intra_chunk` by batch, chunks and heads; a shard along the
sequence, a chunk's rows or the head or state width raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._dtensor import is_dtensor, run_local
from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref


class SsdIntraChunk(torch.autograd.Function):
    """`forward(x, dA, Bm, Cm)` (the CUDA kernel on the card) with the
    gradient of `ssd_intra_chunk_ref`: the backward recomputes the plain
    version on the saved inputs and differentiates it against the incoming
    gradients of (y_intra, S_chunk, decay). The forward is an argument so
    that a CPU test can pass the plain version and check the backward."""

    @staticmethod
    def forward(ctx, forward, x, dA, Bm, Cm):
        ctx.save_for_backward(x, dA, Bm, Cm)
        return forward(x, dA, Bm, Cm)

    @staticmethod
    def backward(ctx, g_y, g_s, g_decay):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = ssd_intra_chunk_ref(*ins)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt,
                                             (g_y, g_s, g_decay)))
        return (None,) + tuple(next(grads) if n else None for n in need)


def ssd_intra_chunk(x, dA, Bm, Cm):
    """x: (B, nc, Q, nh, hd); dA: (B, nc, Q, nh); Bm/Cm: (B, nc, Q, ds),
    float32. Returns y_intra, S_chunk, decay (see `ref.py`)."""
    if is_dtensor(x, dA, Bm, Cm):
        bc = {"batch": 0, "chunks": 1}
        heads = dict(bc, heads=3)
        return run_local(ssd_intra_chunk, "ssd_intra_chunk", (x, dA, Bm, Cm),
                         (heads, heads, bc, bc),
                         (heads, dict(bc, heads=2), dict(bc, heads=2)))
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dA, Bm, Cm)
    return SsdIntraChunk.apply(_kernel.ssd_intra_chunk, x, dA, Bm, Cm)


def chunk_inputs(x, dt, A, B, C, chunk: int):
    """The kernel's inputs from the scan's: x * dt and dt * A in float32,
    B and C in float32, each cut into chunks of `chunk` rows and
    contiguous. Returns xc (b, nc, Q, nh, hd), dAc (b, nc, Q, nh), Bc and
    Cc (b, nc, Q, ds)."""
    b, S, nh, hd = x.shape
    ds, nc = B.shape[-1], S // chunk
    return ((x * dt[..., None]).float().reshape(b, nc, chunk, nh, hd)
            .contiguous(),
            (dt * A[None, None, :]).float().reshape(b, nc, chunk, nh)
            .contiguous(),
            B.float().reshape(b, nc, chunk, ds).contiguous(),
            C.float().reshape(b, nc, chunk, ds).contiguous())


def ssd_scan(x, dt, A, B, C, *, chunk: int = 256, h0=None):
    """Full SSD: y (b, S, nh, hd) and final state (b, nh, hd, ds).

    x: (b, S, nh, hd); dt: (b, S, nh) positive; A: (nh,) negative;
    B, C: (b, S, ds); h0: the state (b, nh, hd, ds) entering the first
    chunk, or None for zeros. S must be a multiple of `chunk`, as in the
    reference (`src/repro/kernels/ssd_scan/ops.py`). The intra-chunk part
    runs in `ssd_intra_chunk`, the inter-chunk recurrence is a loop over
    chunks."""
    if is_dtensor(x, dt, A, B, C, h0):
        def local(x, dt, A, B, C, *h0):
            return ssd_scan(x, dt, A, B, C, chunk=chunk,
                            h0=h0[0] if h0 else None)

        heads, state = {"batch": 0, "heads": 2}, {"batch": 0, "heads": 1}
        args = (x, dt, A, B, C) + (() if h0 is None else (h0,))
        dims = (heads, heads, {"heads": 0}, {"batch": 0}, {"batch": 0},
                state)
        return run_local(local, "ssd_scan", args, dims[:len(args)],
                         (heads, state))
    b, S, nh, hd = x.shape
    if S % chunk:
        raise ValueError(f"ssd_scan: S={S} is not a multiple of "
                         f"chunk={chunk}")
    xc, dAc, Bc, Cc = chunk_inputs(x, dt, A, B, C, chunk)
    y_intra, s_chunk, decay = ssd_intra_chunk(xc, dAc, Bc, Cc)
    # the state entering each chunk: h <- h * decay_c + S_c
    h = torch.zeros_like(s_chunk[:, 0]) if h0 is None else h0.float()
    enter = []
    for c in range(s_chunk.shape[1]):
        enter.append(h)
        h = h * decay[:, c, :, None, None] + s_chunk[:, c]
    y_inter = torch.einsum("bnqd,bnqh,bnhpd->bnqhp", Cc,
                           torch.exp(torch.cumsum(dAc, dim=2)),
                           torch.stack(enter, dim=1))
    return (y_intra + y_inter).reshape(b, S, nh, hd), h
