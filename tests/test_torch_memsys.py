"""Stage-by-stage parity of the port's `step` with the JAX reference (CPU).

Both implementations start from ONE mid-run state, carried across by
`repro_torch.sim.convert`, and take the same cycles; every `SimState`
leaf must be equal after each step. The reference runs eagerly
(`jax.disable_jit`), so no simulator compile is paid. The mask case uses
a short epoch so the token, bypass and DRAM-pressure epoch paths run
inside the window.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.design import design_params as ref_design_params  # noqa: E402
from repro.core.design import get_design as ref_get_design  # noqa: E402
from repro.sim import memsys as ref_ms  # noqa: E402
from repro.sim.config import SimConfig as RefConfig  # noqa: E402
from repro.sim.workloads import app_matrix  # noqa: E402
from repro_torch.core.design import design_params, get_design  # noqa: E402
from repro_torch.sim import convert  # noqa: E402
from repro_torch.sim import memsys  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.runner import simulate  # noqa: E402

WARM, STEPS = 120, 24


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaves(tree, path="state"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, tree


def _assert_states_equal(port_state, ref_state, msg):
    got = list(_leaves(convert.state_to_numpy(port_state)))
    want = list(_leaves(jax.device_get(ref_state)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, path)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {path}")


def _configs(name, epoch):
    ref_d = ref_get_design(name)
    pt_d = get_design(name)
    if epoch:
        ref_d, pt_d = ref_d.with_(epoch_cycles=epoch), \
            pt_d.with_(epoch_cycles=epoch)
    return (RefConfig(design=ref_d), ref_design_params(ref_d),
            SimConfig(design=pt_d, device="cpu"), design_params(pt_d))


@pytest.mark.parametrize("name", ["gpu-mmu", "pwc", "ideal"])
def test_init_state_matches(name):
    ref_cfg, ref_dp, cfg, dp = _configs(name, None)
    _assert_states_equal(memsys.init_state(cfg, dp),
                         ref_ms.init_state(ref_cfg, ref_dp), "init")


@pytest.mark.parametrize("name,epoch", [("gpu-mmu", None), ("pwc", None),
                                        ("mask", 7)])
def test_step_matches_reference_from_carried_state(name, epoch):
    ref_cfg, ref_dp, cfg, dp = _configs(name, epoch)
    pm = app_matrix(["3DS", "BLK"])
    pm_t = convert.params_mat_from_numpy(pm, "cpu")
    np.testing.assert_array_equal(convert.params_mat_to_numpy(pm_t), pm)
    state = simulate(dataclasses.replace(cfg, sim_cycles=WARM), dp, pm_t)
    # carry the mid-run state across: port -> numpy -> reference
    treedef = jax.tree_util.tree_structure(ref_ms.init_state(ref_cfg,
                                                             ref_dp))
    ref_state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for _, x in
                  _leaves(convert.state_to_numpy(state))])
    # ... and back, so the port steps a state made from numpy leaves
    state = convert.state_from_numpy(jax.device_get(ref_state), "cpu")
    pm_j = jnp.asarray(pm)
    with jax.disable_jit():
        for cycle in range(WARM, WARM + STEPS):
            ref_state = ref_ms.step(ref_cfg, ref_dp, pm_j, ref_state)
            state = memsys.step(cfg, dp, pm_t, state, cycle)
            _assert_states_equal(state, ref_state, f"cycle {cycle + 1}")
    assert int(state.t) == WARM + STEPS
