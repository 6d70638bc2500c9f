"""Plain PyTorch versions of the SSD intra-chunk kernel and its ground
truth.

`ssd_intra_chunk_ref` computes what the TPU kernel
`src/repro/kernels/ssd_scan/kernel.py::_kernel` computes, per (batch,
chunk, head), in float32: the inclusive cumsum cs of dA over the chunk,
L[q, s] = exp(cs[q] - cs[s]) for s <= q (0 above the diagonal),
y = (C.B^T o L) x, S = sum_s exp(cs_end - cs[s]) x_s B_s^T and
decay = exp(cs_end). It materialises the (B, nc, nh, Q, Q) decay matrices
that the kernel keeps on chip.

`ssd_recurrence_ref` is the O(S) sequential recurrence of
`src/repro/kernels/ssd_scan/ref.py::ssd_recurrence_ref`, the ground truth
of everything SSD.
"""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x, dA, Bm, Cm):
    """x: (B, nc, Q, nh, hd); dA: (B, nc, Q, nh); Bm/Cm: (B, nc, Q, ds).
    Returns y (B, nc, Q, nh, hd), S (B, nc, nh, hd, ds), decay (B, nc, nh),
    all float32."""
    x, dA, Bm, Cm = (t.float() for t in (x, dA, Bm, Cm))
    Q = x.shape[2]
    cs = torch.cumsum(dA, dim=2)                           # (B, nc, Q, nh)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B, nc, Q, Q, nh)
    idx = torch.arange(Q, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    L = torch.where(causal, torch.exp(diff), 0.0)
    G = torch.einsum("bcqd,bcsd->bcqs", Cm, Bm)            # (B, nc, Q, Q)
    M = G[..., None] * L                                   # (B, nc, Q, Q, nh)
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, x)
    d2e = torch.exp(cs[:, :, -1:, :] - cs)                 # (B, nc, Q, nh)
    S = torch.einsum("bcsh,bcshp,bcsd->bchpd", d2e, x, Bm)
    return y, S, torch.exp(cs[:, :, -1, :])


def ssd_recurrence_ref(x, dt, A, B, C):
    """O(S) sequential recurrence. x: (b, S, nh, hd); dt: (b, S, nh);
    A: (nh,); B, C: (b, S, ds). Returns y (b, S, nh, hd) and the final
    state (b, nh, hd, ds), float32."""
    b, S, nh, hd = x.shape
    ds = B.shape[-1]
    h = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None])                 # (b, nh)
        xin = (x[:, t] * dt[:, t, :, None]).float()           # (b, nh, hd)
        h = h * decay[..., None, None] + torch.einsum(
            "bhp,bd->bhpd", xin, B[:, t].float())
        ys.append(torch.einsum("bhpd,bd->bhp", h, C[:, t].float()))
    return torch.stack(ys, dim=1), h
