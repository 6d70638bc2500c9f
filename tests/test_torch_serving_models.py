"""The port's serving engine with real forwards against the reference's,
on the CPU: `launch.serve.build_engine("qwen3-4b")` in both packages (the
reduced model), the reference's params (`init_params(PRNGKey(0))`)
carried to the port through `models/convert.py`, a few requests of two
tenants under the `none` policy.

* Equal fingerprints (admission, decode rotation, completion), equal pool
  planes at the end.
* Every request's first-token logits (its prefill) within atol = rtol =
  3e-2 of the reference's: the bf16 tolerance `tests/test_torch_models.py`
  holds the same reduced qwen3-4b's `forward_prefill` to. Decode logits
  are held to it while both engines have fed the same tokens.
* Tokens: equal wherever the reference's top-2 logit margin is above
  what that tolerance allows each of the two logits to move; a request
  whose tokens part at a closer margin is compared up to there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch.serve import build_engine as jbuild  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.launch.serve import build_engine as pbuild  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving.engine import EngineConfig as PEngineConfig  # noqa: E402
from repro_torch.serving.engine import Request as PRequest  # noqa: E402
from tests.test_torch_serving import fingerprint, same_pool  # noqa: E402

TOL = 3e-2          # tests/test_torch_models.py TOL16, the same model in bf16
PROFILES = {0: "heavy", 1: "interactive"}
REQUESTS = [(0, 0, 8, 4), (1, 1, 12, 3), (2, 0, 8, 5), (3, 1, 8, 2),
            (4, 0, 12, 3)]          # (rid, tenant, prompt length, max_new)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(build, request_cls, ecfg_cls, carry=None, arch="qwen3-4b",
           requests=REQUESTS):
    kw = {} if carry is None else {"device": "cpu"}
    eng = build(arch, policy="none", profiles=PROFILES,
                ecfg=ecfg_cls(max_batch=2, max_running=3), **kw)
    if carry is not None:
        eng.params = convert.tree_from_numpy(
            jax.device_get(carry.params), "cpu")
    logits, serving = {}, {}
    prefill, decode, admit = eng._fwd_prefill, eng._fwd_decode, eng._prefill

    def a(req):                     # the request a prefill serves
        serving["rid"] = req.rid
        admit(req)

    def p(cfg, run, params, batch, max_len=None):
        out, caches = prefill(cfg, run, params, batch, max_len=max_len)
        logits[serving["rid"]] = [_last(out)]
        return out, caches

    def d(cfg, run, params, batch, caches):
        rid = next(r for r, c in eng._prefill_cache.items() if c is caches)
        out, caches = decode(cfg, run, params, batch, caches)
        logits[rid].append(_last(out))
        return out, caches

    eng._prefill, eng._fwd_prefill, eng._fwd_decode = a, p, d
    rng = np.random.RandomState(0)
    for rid, tenant, plen, max_new in requests:
        eng.submit(request_cls(rid=rid, tenant=tenant, max_new=max_new,
                               prompt=rng.randint(0, eng.cfg.vocab_size,
                                                  plen)))
    eng.run_until_drained(max_steps=60)
    return eng, logits


def _last(logits):
    x = logits[0, -1]
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def engines():
    jeng_, jlogits = _serve(jbuild, JRequest, JEngineConfig)
    peng_, plogits = _serve(pbuild, PRequest, PEngineConfig, carry=jeng_)
    return jeng_, jlogits, peng_, plogits


def test_real_forward_schedule_matches_reference(engines):
    jeng_, _, peng_, _ = engines
    assert len(jeng_.finished) == len(REQUESTS)
    assert fingerprint(peng_) == fingerprint(jeng_)
    assert peng_.step_count == jeng_.step_count
    same_pool(jeng_.pool, peng_.pool)
    assert str(peng_.device) == "cpu"


def _margin_bound(x):
    """How far apart the top two logits must be for `TOL` (atol = rtol) to
    keep their order: each may move by TOL * (1 + |value|)."""
    a, b = np.sort(x)[-2:]
    return (b - a), TOL * (2 + abs(a) + abs(b))


def test_real_forward_logits_and_tokens_match_reference(engines):
    jeng_, jlogits, peng_, plogits = engines
    assert sorted(jlogits) == sorted(plogits) == [r[0] for r in REQUESTS]
    jout = {r.rid: r.out for r in jeng_.finished}
    pout = {r.rid: r.out for r in peng_.finished}
    compared = 0
    for rid, _, _, max_new in REQUESTS:
        jl, pl = jlogits[rid], plogits[rid]
        assert len(jl) == len(pl) == max_new + 1
        # the first token's logits: the same prompt through both prefills
        np.testing.assert_allclose(pl[0], jl[0], atol=TOL, rtol=TOL)
        for i in range(max_new + 1):
            np.testing.assert_allclose(pl[i], jl[i], atol=TOL, rtol=TOL)
            margin, bound = _margin_bound(jl[i])
            if margin > bound:
                assert pout[rid][i] == jout[rid][i], (rid, i, margin)
                compared += 1
            elif pout[rid][i] != jout[rid][i]:
                break           # the engines feed different tokens from here
    assert compared >= len(REQUESTS)
