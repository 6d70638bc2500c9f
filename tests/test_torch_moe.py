"""Parity of the port's MoE FFN (`repro_torch.models.moe`) with the
reference's `repro.models.moe` on the CPU.

The same seeded inputs and params (drawn with numpy, fp32 or bf16 experts
with the float32 router) go through both `moe_apply`s. The reference's
routing internals are read while it runs: `jax.lax.top_k`'s indices and
the outputs of its `jax.vmap` calls (slot positions, the token and weight
slot tables) are recorded through a stand-in for the module's `jax`
(`_Recorder`), so nothing of the reference is copied here.

* Routing is exact: top-k indices, slot positions, the token slot table
  (the trash slot sliced off, as the reference slices it), which slots
  carry a weight, and `dropped_frac` are equal element for element. The
  gate weights in the weight table are float32 sums of the router's
  products in another order: within 1e-5.
* Values: the output, `lb_loss` and `z_loss` within atol = rtol = 1e-5 in
  fp32 (the same float32 arithmetic in another order) and 3e-2 in bf16
  (about four bf16 steps at the outputs' magnitude).
* Cases: (E, K) = (8, 2) and (16, 4) with no drops (capacity_factor = E);
  capacity_factor 1.0 with drops; decode with S == 1 and B > 1 routed as
  ONE group; rows with tied router scores (a zero row: every expert ties;
  duplicated router columns: pairs tie), where the top K must take the
  lower expert index first as `jax.lax.top_k` does.
* Two runs of the port are bit-equal (the combine is a gather).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402

TOL32 = 1e-5
TOL16 = 3e-2
D, F = 32, 48


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Recorder:
    """Stands in for `jax` inside `repro.models.moe`: forwards everything,
    and records what `lax.top_k` and each `vmap`-ed call return."""

    def __init__(self):
        self.top_k, self.vmaps = [], []
        rec = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            @staticmethod
            def top_k(x, k):
                out = jax.lax.top_k(x, k)
                rec.top_k.append(np.asarray(out[1]))
                return out
        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def call(*args):
            out = mapped(*args)
            self.vmaps.append(np.asarray(out.astype(jnp.float32)))
            return out
        return call


def _params(E, dtype, seed=0, tie_cols=False):
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(D, E).astype(np.float32) / np.sqrt(D),
         "w_gate": rng.randn(E, D, F).astype(np.float32) / np.sqrt(D),
         "w_up": rng.randn(E, D, F).astype(np.float32) / np.sqrt(D),
         "w_down": rng.randn(E, F, D).astype(np.float32) / np.sqrt(F)}
    if tie_cols:       # experts 2j and 2j+1 get equal router scores
        p["router"][:, 1::2] = p["router"][:, 0::2]
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else dtype)
          for k, v in p.items()}
    pp = convert.tree_from_numpy(jax.device_get(jp), "cpu")
    return jp, pp


def _x(B, S, dtype, seed=1, zero_rows=()):
    x = np.random.RandomState(seed).randn(B, S, D).astype(np.float32) * .5
    for b, s in zero_rows:
        x[b, s] = 0.0
    jx = jnp.asarray(x, dtype)
    return jx, convert.tensor_from_numpy(np.asarray(jx.astype(jnp.float32)),
                                         "cpu", torch.float32
                                         if dtype == jnp.float32
                                         else torch.bfloat16)


def _run(monkeypatch, jp, pp, jx, px, K, cf):
    rec = _Recorder()
    with monkeypatch.context() as m:
        m.setattr(jmoe, "jax", rec)
        jout, jaux = jmoe.moe_apply(jp, jx, top_k=K, capacity_factor=cf)
    pout, paux = pmoe.moe_apply(pp, px, top_k=K, capacity_factor=cf)
    return rec, (jout, jaux), (pout, paux)


def _port_tables(pp, px, K, cf):
    """The port's routing for the group layout moe_apply uses."""
    B, S, _ = px.shape
    if S == 1 and B > 1:
        px = px.reshape(1, B, -1)
        B, S = 1, B
    E = pp["router"].shape[-1]
    cap = pmoe.capacity(S, K, E, cf)
    _, _, gv, gi = pmoe.route(pp, px, K)
    slot, tok_tbl, w_tbl, valid = pmoe.slot_tables(gv, gi, E, cap)
    return gi, tok_tbl, w_tbl, valid, E * cap


CASES = [  # (B, S, E, K, capacity_factor, dtype, zero rows, tied columns)
    (2, 32, 8, 2, 8.0, "float32", (), False),
    (2, 32, 16, 4, 16.0, "float32", (), False),
    (2, 32, 8, 2, 8.0, "bfloat16", (), False),
    (2, 32, 16, 4, 16.0, "bfloat16", (), False),
    (2, 64, 8, 2, 1.0, "float32", (), False),        # drops
    (2, 64, 8, 2, 1.0, "bfloat16", (), False),
    (6, 1, 8, 2, 1.25, "float32", (), False),        # decode: one group
    (6, 1, 16, 4, 1.25, "bfloat16", (), False),
    (2, 16, 8, 2, 1.25, "float32", ((0, 3), (1, 0), (1, 9)), False),
    (2, 16, 8, 2, 1.25, "float32", ((0, 5),), True),  # tied pairs
]


@pytest.mark.parametrize("B,S,E,K,cf,dtype,zero_rows,tie_cols", CASES)
def test_moe_apply_matches_reference(monkeypatch, B, S, E, K, cf, dtype,
                                     zero_rows, tie_cols):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tol = TOL32 if dtype == "float32" else TOL16
    jp, pp = _params(E, jdt, seed=E + K, tie_cols=tie_cols)
    jx, px = _x(B, S, jdt, seed=S, zero_rows=zero_rows)
    rec, (jout, jaux), (pout, paux) = _run(monkeypatch, jp, pp, jx, px, K,
                                           cf)
    # routing: exact
    gi, tok_tbl, w_tbl, valid, n = _port_tables(pp, px, K, cf)
    assert len(rec.top_k) == 1 and len(rec.vmaps) == 5
    assert np.array_equal(gi.numpy(), rec.top_k[0])
    _, pos, jtok, jw, _ = rec.vmaps
    assert np.array_equal(tok_tbl.numpy(), jtok[:, :n].astype(np.int64))
    assert np.array_equal(w_tbl.numpy() == 0, jw[:, :n] == 0)
    np.testing.assert_allclose(w_tbl.numpy(), jw[:, :n], atol=TOL32,
                               rtol=TOL32)
    assert np.array_equal(valid.numpy(), pos < n // E)
    assert float(paux["dropped_frac"]) == float(jaux["dropped_frac"])
    if cf >= E:
        assert float(paux["dropped_frac"]) == 0.0
    if cf == 1.0:
        assert 0.0 < float(paux["dropped_frac"]) < 0.5
    # values
    assert pout.dtype == px.dtype and tuple(pout.shape) == jout.shape
    np.testing.assert_allclose(convert.tensor_to_numpy(pout),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(paux[key]), float(jaux[key]),
                                   atol=tol, rtol=tol)


def test_ties_take_the_lower_expert():
    """A zero row ties every expert: the top K are 0..K-1, as
    `jax.lax.top_k` gives them; tied column pairs give 2j before 2j+1."""
    _, pp = _params(8, jnp.float32, tie_cols=True)
    _, px = _x(1, 4, jnp.float32, zero_rows=((0, 2),))
    _, _, _, gi = pmoe.route(pp, px, 4)
    assert gi[0, 2].tolist() == [0, 1, 2, 3]
    for row in gi[0].tolist():
        for e in row:
            if e % 2:               # an odd expert's even twin comes first
                assert e - 1 in row[:row.index(e)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_runs_bit_equal(dtype):
    _, pp = _params(8, jnp.float32 if dtype == torch.float32
                    else jnp.bfloat16)
    x = torch.randn(3, 24, D, generator=torch.Generator().manual_seed(5))
    a, _ = pmoe.moe_apply(pp, x.to(dtype), top_k=2)
    b, _ = pmoe.moe_apply(pp, x.to(dtype), top_k=2)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32))


@pytest.mark.parametrize("S,K,E,cf", [(2048, 8, 64, 1.25), (1, 8, 64, 1.25),
                                      (4, 8, 64, 1.25), (16, 2, 8, 1.25),
                                      (20, 2, 8, 1.0), (5, 2, 8, 2.5)])
def test_capacity_matches_reference(S, K, E, cf):
    """`capacity` is the reference's expression, host ints and Python's
    half-to-even round (5 * 2 / 8 * 2.5 = 3.125, 20 * 2 / 8 = 5.0)."""
    want = min(jmoe._round_up(int(max(1, round(S * K / E * cf))), 8), S * K)
    assert pmoe.capacity(S, K, E, cf) == want
