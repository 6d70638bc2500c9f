"""The port's serving engine with real forwards of the MoE, encoder-decoder
and patch-input families against the reference's, on the CPU:
`launch.serve.build_engine(arch)` in both packages for reduced
olmoe-1b-7b, whisper-base (zero frames of enc_len 24, as the engine
builds them) and phi-3-vision-4.2b (8 zero patch embeddings ahead of each
prompt), the reference's params carried across, a few requests of two
tenants under the `none` policy (no oracle: nothing of the simulator is
compiled). The helpers are `tests/test_torch_serving_models.py`'s.

* Equal fingerprints (admission, decode rotation, completion), equal
  step counts and pool planes.
* Every request's logits (prefill, then each decode step) within the
  bf16 limit `tests/test_torch_model_families.py` holds these models to
  (3e-2 of the largest |logit|: whisper's tied embedding makes logits
  of ~140).
* Tokens: equal, unless they part where the reference's top-2 logit
  margin is within what that limit lets each of the two logits move; a
  request is compared up to there.

Prompts are 5 to 8 tokens: with 8 patches ahead, the phi-3-vision prefill
is at most 16 rows, which the engine's 16-row attention blocks tile in
both packages (a longer prompt must be a multiple of 16 rows).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.serve import build_engine as jbuild  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.launch.serve import build_engine as pbuild  # noqa: E402
from repro_torch.serving.engine import EngineConfig as PEngineConfig  # noqa: E402
from repro_torch.serving.engine import Request as PRequest  # noqa: E402
from tests.test_torch_serving import fingerprint, same_pool  # noqa: E402
from tests.test_torch_serving_models import _serve  # noqa: E402

TOL = 3e-2
REQUESTS = [(0, 0, 8, 4), (1, 1, 5, 3), (2, 0, 8, 3), (3, 1, 7, 2)]
ARCHS = ["olmoe-1b-7b", "whisper-base", "phi-3-vision-4.2b"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_served_as_reference(arch):
    jeng, jlogits = _serve(jbuild, JRequest, JEngineConfig, arch=arch,
                           requests=REQUESTS)
    peng, plogits = _serve(pbuild, PRequest, PEngineConfig, carry=jeng,
                           arch=arch, requests=REQUESTS)
    assert peng.cfg.name == jeng.cfg.name == arch + "-smoke"
    assert len(jeng.finished) == len(REQUESTS)
    assert fingerprint(peng) == fingerprint(jeng)
    assert peng.step_count == jeng.step_count
    same_pool(jeng.pool, peng.pool)
    assert sorted(jlogits) == sorted(plogits) == [r[0] for r in REQUESTS]
    jout = {r.rid: r.out for r in jeng.finished}
    pout = {r.rid: r.out for r in peng.finished}
    compared = 0
    for rid, _, _, max_new in REQUESTS:
        jl, pl = jlogits[rid], plogits[rid]
        assert len(jl) == len(pl) == max_new + 1
        for i in range(max_new + 1):
            scale = max(1.0, float(np.abs(jl[i]).max()))
            np.testing.assert_allclose(pl[i], jl[i], atol=TOL * scale,
                                       rtol=TOL)
            if pout[rid][i] != jout[rid][i]:
                a, b = np.sort(jl[i])[-2:]
                assert b - a <= 2 * TOL * scale + TOL * (abs(a) + abs(b)), \
                    (rid, i, b - a)
                break           # the engines feed different tokens from here
            compared += 1
    assert compared >= len(REQUESTS)
