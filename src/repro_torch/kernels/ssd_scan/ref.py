"""Plain PyTorch versions of the SSD intra-chunk kernel and its ground
truth.

`ssd_intra_chunk_ref` computes what the TPU kernel
`src/repro/kernels/ssd_scan/kernel.py::_kernel` computes, per (batch,
chunk, head), in float32: the inclusive cumsum cs of dA over the chunk,
L[q, s] = exp(cs[q] - cs[s]) for s <= q (0 above the diagonal),
y = (C.B^T o L) x, S = sum_s exp(cs_end - cs[s]) x_s B_s^T and
decay = exp(cs_end). It materialises the (B, nc, nh, Q, Q) decay matrices
that the kernel keeps on chip.

`ssd_intra_chunk_split_ref` is the same step with the CUDA kernel's
arithmetic: each of its three products (G = C.B^T, y = M.x and S) in split
TF32, a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi with a_hi = tf32(a) and
a_lo = tf32(a - a_hi) (`_tf32.tf32_round`, as `cvt.rna.tf32.f32`
rounds). It lets the CPU tests hold that arithmetic to the reference;
nothing on a model path calls it. `ssd_limits` is the per-element limit,
from each output's sum of |terms|, within which that arithmetic must stay
of `ssd_intra_chunk_ref` at a model shape.

`ssd_recurrence_ref` is the O(S) sequential recurrence of
`src/repro/kernels/ssd_scan/ref.py::ssd_recurrence_ref`, the ground truth
of everything SSD.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._tf32 import split_einsum, tf32_round  # noqa: F401


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
    # masked before the exp: above the diagonal cs[q] - cs[s] > 0 can
    # overflow, and a gradient through where(causal, exp(diff), 0) would
    # be 0 * inf there
    L = torch.exp(torch.where(causal, diff, float("-inf")))
    G = torch.einsum("bcqd,bcsd->bcqs", Cm, Bm)            # (B, nc, Q, Q)
    M = G[..., None] * L                                   # (B, nc, Q, Q, nh)
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, x)
    d2e = torch.exp(cs[:, :, -1:, :] - cs)                 # (B, nc, Q, nh)
    S = torch.einsum("bcsh,bcshp,bcsd->bchpd", d2e, x, Bm)
    return y, S, torch.exp(cs[:, :, -1, :])


def ssd_intra_chunk_split_ref(x, dA, Bm, Cm):
    """`ssd_intra_chunk_ref` with its three products in split TF32, as the
    CUDA kernel computes them: G = C.B^T, y = (G o L).x with G o L split,
    S = (d2e o x)^T.B with d2e applied to x before the split."""
    x, dA, Bm, Cm = (t.float() for t in (x, dA, Bm, Cm))
    Q = x.shape[2]
    cs = torch.cumsum(dA, dim=2)                           # (B, nc, Q, nh)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]     # (B, nc, Q, Q, nh)
    idx = torch.arange(Q, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    L = torch.where(causal, torch.exp(diff), 0.0)
    G = split_einsum("bcqd,bcsd->bcqs", Cm, Bm)            # (B, nc, Q, Q)
    M = G[..., None] * L                                   # (B, nc, Q, Q, nh)
    y = split_einsum("bcqsh,bcshp->bcqhp", M, x)
    d2e = torch.exp(cs[:, :, -1:, :] - cs)                 # (B, nc, Q, nh)
    S = split_einsum("bcshp,bcsd->bchpd", d2e[..., None] * x, Bm)
    return y, S, torch.exp(cs[:, :, -1, :])


EPS32 = 2.0 ** -23                     # float32 machine epsilon
SPLIT_TF32 = 3 * 2.0 ** -22            # relative error of a split-TF32 product


def ssd_limits(x, dA, Bm, Cm):
    """Per-element limits for the CUDA kernel against `ssd_intra_chunk_ref`
    at a model shape, from each output's sum of |terms|.

    Both sides sum the same products in other orders: y[q, p] and S[p, d]
    are chains of at most n = ds + Q float32 products and sums (G over
    ds, then over the chunk's rows), each rounding at most eps relative,
    so they differ by at most 2 n eps sum|terms|. Each side also rounds
    the cumsum of dA, by at most eps sum_i |cs_i| (its partial sums), and
    that enters exp(cs[q] - cs[s]) and exp(cs_end - cs[s]) as a relative
    error: 4 eps sum_i |cs_i| sum|terms| for the two sides and two ends.

    The kernel runs its products in split TF32: a = a_hi + a_lo + a_r with
    a_hi = tf32(a) within 2^-11 |a| of a and a_lo = tf32(a - a_hi), so
    |a_r| <= 2^-22 |a|; it sums a_hi b_hi + a_hi b_lo + a_lo b_hi, each
    partial product exact in float32, and drops a_lo b_lo + a_hi b_r +
    a_r b (+ a_lo b_r, of order 2^-33), at most ~3 2^-22 |a||b| per
    product (SPLIT_TF32). y chains two such products (G = C.B^T, then
    (G o L).x), S one, so their limits gain 2 SPLIT_TF32 and SPLIT_TF32
    of sum|terms|.

    sum|terms| is the plain version on |x|, |B|, |C| (L and the decays
    are positive). A missing row of one s tile already moves y by ~1/Q of
    sum|terms|, above this limit, so the limit rejects a wrong head or q
    tile. Returns the limits of y, S and decay."""
    ys, ss, dec = ssd_intra_chunk_ref(x.abs(), dA, Bm.abs(), Cm.abs())
    e_cs = EPS32 * torch.cumsum(dA, dim=2).abs().sum(dim=2)   # (B, nc, nh)
    rel = 2 * (Bm.shape[-1] + x.shape[2]) * EPS32 + 4 * e_cs
    rel_y, rel_s = rel + 2 * SPLIT_TF32, rel + SPLIT_TF32
    return (rel_y[:, :, None, :, None] * ys, rel_s[:, :, :, None, None] * ss,
            (4 * e_cs + EPS32) * dec)


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
