"""The port's train loop and launcher (`repro_torch.train.loop`,
`repro_torch.launch.train`) on the CPU.

* The reference's `test_loss_decreases` and `test_checkpoint_restart_exact`
  (`tests/test_train_ckpt_ft.py`) on the port: reduced qwen3-4b, 30 steps
  with the loss falling by more than 0.1; a run cut at 10 steps and
  resumed to 14 bit-equal to an unbroken 14 (params and optimizer state).
* The loop from the reference's own params (bf16, carried across with
  `init_fn=`) against the reference's loop: 3 steps' losses within 2e-3
  (relative; bf16 roundings in another order).
* `python -m repro_torch.launch.train --smoke --device cpu` for 3 steps.
* `train()` and the launcher run on the card by default and raise without
  one.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced_model as j_reduced  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import ARCHS, reduced_model  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny_run(steps=12, ckpt_dir=None, seed=0):
    """The reference test's run (tests/test_train_ckpt_ft.py::_tiny_run)."""
    cfg = reduced_model(ARCHS["qwen3-4b"])
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    run = RunConfig(model=cfg, shape=shape, remat=False,
                    attn_block_q=16, attn_block_k=16)
    tcfg = TrainConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5,
                       log_every=2, seed=seed,
                       opt=opt_mod.OptConfig(lr=2e-3, warmup_steps=2))
    return cfg, run, tcfg


def _quiet(*_):
    pass


def test_loss_decreases():
    cfg, run, tcfg = _tiny_run(steps=30)
    hist = train(cfg, run, tcfg, log=_quiet, device="cpu")["history"]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1


def _same_state(a, b):
    for key in ("params", "opt_state"):
        items_a, items_b = tree_items(a[key]), tree_items(b[key])
        assert [p for p, _ in items_a] == [p for p, _ in items_b]
        for (path, x), (_, y) in zip(items_a, items_b):
            assert x.dtype == y.dtype and torch.equal(x, y), (key, path)


def test_checkpoint_restart_exact(tmp_path):
    """Crash after step 10, restart, and land bit-identical to an unbroken
    run (deterministic data skip-ahead + atomic snapshots)."""
    def run_to(steps, d):
        cfg, run, tcfg = _tiny_run(steps=steps, ckpt_dir=str(tmp_path / d))
        return train(cfg, run, tcfg, log=_quiet, device="cpu")

    _same_state(run_to(10, "a"), run_to(10, "b"))
    resumed = run_to(14, "a")
    assert resumed["history"][0]["step"] == 10      # resumed, not rerun
    _same_state(resumed, run_to(14, "d"))


def test_loop_matches_reference_from_its_params():
    jcfg = j_reduced(J_ARCHS["qwen3-4b"])
    cfg = reduced_model(ARCHS["qwen3-4b"])
    kw = dict(remat=True, attn_block_q=16, attn_block_k=16)
    jrun = JRun(model=jcfg, shape=JShape("t", 48, 2, "train"), **kw)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 48, 2, "train"), **kw)
    opt = dict(lr=2e-3, warmup_steps=2)
    jt = jloop.TrainConfig(steps=3, log_every=1, seed=3,
                           opt=jopt.OptConfig(**opt))
    want = jloop.train(jcfg, jrun, jt, log=_quiet)["history"]
    params = convert.tree_from_numpy(jax.device_get(
        jM.init_params(jax.random.PRNGKey(3), jcfg)), "cpu")
    tcfg = TrainConfig(steps=3, log_every=1, seed=3,
                       opt=opt_mod.OptConfig(**opt))
    got = train(cfg, run, tcfg, log=_quiet, device="cpu",
                init_fn=lambda: (params, opt_mod.init(params, tcfg.opt)))
    got = got["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-3, err_msg=k)


def test_launcher_smoke_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-4b", "--smoke", "--steps", "3",
        "--seq-len", "32", "--batch", "2", "--device", "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "first loss" in out


def test_default_device_raises_without_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    cfg, run, tcfg = _tiny_run(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, run, tcfg, log=_quiet)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-4b",
                                      "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main()
