"""The cycle step with the cycle on the device, and its replay (CPU).

* The stages read the cycle from the state's device scalar `t`: a plain
  loop of `memsys.step` whose host cycle is read back from `state.t`
  every cycle gives the float-hex 1200-cycle goldens of
  `tests/test_memsys_stages.py` (one fused round and two), and `mask`
  with its epoch cut to 40 equals the reference across three epochs.
* The replay's bookkeeping (`sim/replay.py`): its static buffers, the
  split at each fused round, the round's outputs copied in, states copied
  in and out, and the eager epoch cycles, run here with `ReplayGraph`, a
  stand-in for `torch.cuda.CUDAGraph` that records the aten calls of a
  captured stretch and re-runs them on replay. Replayed, a grid of
  per-row knobs across three epochs and a `run_trace` with churn, faults
  and the audit equal the plain loop float-hex.
* Each cycle calls `ops.fused_tlb_access` once a round, with its
  signature, whether it replays or not.
* The cache: one entry per key, reused by a later pass, a new one for
  another row count or host knob, the least recently used evicted past
  the bound; a pass hands back a copy, not the key's buffers.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro.core.design import get_design as ref_get_design  # noqa: E402
from repro.sim import runner as ref_runner  # noqa: E402
from repro_torch.core.design import (design_params, get_design,  # noqa: E402
                                     stack_params)
from repro_torch.kernels.fused_tlb import ops as fused_ops  # noqa: E402
from repro_torch.sim import faults, memsys, replay, runner  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.workloads import (FIELD, app_matrix,  # noqa: E402
                                       churn_schedule)

MIX = ["3DS", "BLK"]
EPOCH = 40
CYCLES = 131                   # three epochs (t = 40, 80, 120)
SHORT = 59                     # a two-round pass
SEG = 47                       # a trace's segment (a plan of its own)


def _load_golden():
    path = Path(__file__).with_name("test_memsys_stages.py")
    spec = importlib.util.spec_from_file_location("_memsys_stage_pins", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDEN


GOLDEN = _load_golden()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------- the stand-in graph

# calls that read a value back to the host or size an output by its
# data: a CUDA capture refuses them, so the stand-in does too
_HOST_READS = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default}


class _Record(TorchDispatchMode):
    """Records every aten call (function, arguments, result). A call that
    writes a tensor made before the capture keeps its value first, so the
    capture can leave the tensors it found as a CUDA capture does: as
    they were."""

    def __init__(self, ops):
        super().__init__()
        self.ops, self.made, self.before = ops, set(), {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError(f"{func} in a captured stretch")
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage().data_ptr() not in self.made:
                key = (t.data_ptr(), tuple(t.shape), t.stride())
                self.before.setdefault(key, (t, t.clone()))
        out = func(*args, **kwargs)
        if all(r.alias_info is None for r in schema.returns):
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    self.made.add(o.untyped_storage().data_ptr())
        self.ops.append((func, args, kwargs, out))
        return out


class ReplayGraph:
    """A stand-in for `torch.cuda.CUDAGraph` on the CPU: `replay` re-runs
    the recorded calls on the recorded arguments and writes each result
    into the tensor the capture gave back (its static address)."""

    def capture_begin(self, pool=None):
        self.ops = []
        self._mode = _Record(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        for t, value in reversed(list(self._mode.before.values())):
            t.copy_(value)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            for o, r in zip(tree_flatten(out)[0], tree_flatten(res)[0]):
                if isinstance(o, torch.Tensor) and \
                        o.data_ptr() != r.data_ptr():
                    o.copy_(r)


# ------------------------------------------------------------ helpers

_leaves = replay._leaves


def _same_state(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(_leaves(a), _leaves(b)))


def _same_stats(a, b):
    return set(a) == set(b) and all(
        np.asarray(a[k], np.float64).tobytes()
        == np.asarray(b[k], np.float64).tobytes() for k in a)


def _grid():
    """Four designs of one signature group, epoch cut to EPOCH, each
    knob that differs an (R,) tensor: 2 mixes each, R = 8."""
    names = ("mask", "gpu-mmu", "mask-tlb", "mask-dram")
    ds = [get_design(n).with_(epoch_cycles=EPOCH) for n in names]
    cfg = SimConfig(design=ds[0], sim_cycles=CYCLES, device="cpu")
    dp = stack_params([design_params(d) for d in ds], 2, "cpu")
    mixes = [MIX, ["MUM", None]] * len(ds)
    pm = torch.tensor(np.stack([app_matrix(m) for m in mixes]))
    return cfg, dp, pm


def _run(eng, cfg, dp, pm, cycles):
    """(final state, whether each cycle replayed) of a plain loop of
    `memsys.step` (`eng` None) or of `eng.step`."""
    flags = []
    with torch.inference_mode():
        st = memsys.init_state(cfg, dp, rows=pm.shape[0])
        for cycle in range(cycles):
            if eng is None:
                st, r = memsys.step(cfg, dp, pm, st, cycle), False
            else:
                st, r = eng.step(cfg, dp, pm, st, cycle)
            flags.append(r)
        return (st if eng is None else eng.detach(st)), flags


# ------------------------------------------------ the cycle on the device

@pytest.mark.parametrize("name", ["pwc", "mask"])
def test_cycle_read_from_the_state_gives_the_goldens(name):
    """A plain loop whose host cycle is only ever `state.t` read back:
    the 1200-cycle golden of the design, float-hex."""
    cfg = SimConfig(design=name, n_apps=2, sim_cycles=1200, device="cpu")
    dp = design_params(cfg.design)
    pm = torch.tensor(app_matrix(MIX))[None]
    with torch.inference_mode():
        st = memsys.init_state(cfg, dp, rows=1)
        while int(st.t[0]) < 1200:
            st = memsys.step(cfg, dp, pm, st, int(st.t[0]))
    assert st.t.dtype == torch.int32 and st.t.tolist() == [1200]
    s = runner._stats(cfg, memsys.map_state(lambda x: x[0].numpy(), st))
    for key, want in GOLDEN[name].items():
        got = [x.hex() for x in np.asarray(s[key], np.float64).ravel()]
        assert got == want, f"{name}:{key}"


def test_cycle_on_the_device_across_epochs_equals_the_reference():
    """`mask` with its epoch cut to 40: three epochs of the token
    climb, DRAM pressure and bypass latch in 131 cycles, the port's plain
    loop (the cycle from `state.t`) against the reference."""
    d = get_design("mask").with_(epoch_cycles=EPOCH)
    cfg = SimConfig(design=d, n_apps=2, sim_cycles=CYCLES, device="cpu")
    st, _ = _run(None, cfg, design_params(d),
                 torch.tensor(app_matrix(MIX))[None], CYCLES)
    got = runner._stats(cfg, memsys.map_state(lambda x: x[0].numpy(), st))
    want = ref_runner.run_mix(ref_get_design("mask").with_(
        epoch_cycles=EPOCH), MIX, cycles=CYCLES)
    assert _same_stats({k: got[k] for k in want}, want)
    plain = ref_runner.run_mix("mask", MIX, cycles=CYCLES)
    assert not _same_stats({k: got[k] for k in plain}, plain)


def test_stages_take_the_cycle_as_a_host_int_or_a_device_scalar():
    """One cycle's stages given the cycle as a Python int and as a 0-dim
    int32 tensor: the same values in the same dtypes."""
    cfg = SimConfig(design="mask", n_apps=2, sim_cycles=9, device="cpu")
    dp = design_params(cfg.design)
    pm = torch.tensor(np.stack([app_matrix(MIX), app_matrix(["MUM", None])]))
    with torch.inference_mode():
        st = runner.simulate(cfg, dp, pm)
        outs = []
        for t in (10, torch.tensor(10, dtype=torch.int32)):
            s = memsys.map_state(torch.clone, st)
            sched = memsys.warp_sched(cfg, pm, s.stall_until, s.pos, t,
                                      asid_of_app=s.asid_of_app)
            trans, probe = memsys.translation_probe(cfg, dp, s.trans,
                                                    s.tokens, sched, t, 10)
            front = memsys.datapath_front(cfg, pm, sched, t)
            data, mem = memsys.shared_memory_access(
                cfg, dp, s.data, sched.app, probe.walk_lines, probe.walk_go,
                probe.walk_tags, front.lines, front.go_l2d, t, 10)
            trans, tout = memsys.translation_commit(cfg, trans, probe, mem,
                                                    sched, t)
            dout = memsys._data_out(cfg, front, mem)
            gap = pm[:, sched.app, FIELD["gap"]]
            retired = memsys.retire(s.stall_until, s.instr, s.pos, sched,
                                    tout.trans_lat + dout.data_lat + gap,
                                    gap, t)
            stats = memsys.accumulate_stats(s.stats, cfg.n_apps, sched,
                                            tout, dout, t)
            outs.append((sched, trans, probe, front, data, mem, tout,
                         retired, stats))
    a, b = (tree_flatten(o)[0] for o in outs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ the replay

def test_replay_of_a_knob_grid_across_epochs_equals_the_plain_loop():
    """Per-row knobs, three epochs: replayed with the stand-in, float-hex
    equal to the plain loop; the key's first cycle and the epoch cycles
    run eagerly, the second is captured, every other cycle replays."""
    cfg, dp, pm = _grid()
    want, _ = _run(None, cfg, dp, pm, CYCLES)
    eng = replay.Graphs(graph=ReplayGraph)
    got, flags = _run(eng, cfg, dp, pm, CYCLES)
    assert _same_state(got, want)
    eager = [c for c, r in enumerate(flags) if not r]
    assert eager == [0, 1, 39, 79, 119]
    (e,) = eng.entries.values()
    assert eng.captures == 1 and len(e.graphs) == 2 and len(e.rounds) == 1
    assert not set(e.ptrs) & {x.data_ptr() for x in _leaves(got)}


def test_replay_with_two_rounds_copies_each_rounds_outputs_in():
    """`pwc` stacked with `gpu-mmu` (a PWC round masked per row and the
    L2$ round): three graphs and two rounds a cycle, and a later pass
    with other workloads and another start state replays the same
    record."""
    ds = [get_design(n) for n in ("pwc", "gpu-mmu")]
    cfg = SimConfig(design=ds[0], sim_cycles=SHORT, device="cpu")
    dp = stack_params([design_params(d) for d in ds], 2, "cpu")
    pms = [torch.tensor(np.stack([app_matrix(m) for m in mixes]))
           for mixes in ([MIX, ["MUM", None]] * 2,
                         [["HISTO", "BFS2"], ["SCAN", "FWT"]] * 2)]
    eng = replay.Graphs(graph=ReplayGraph)
    for pm in pms:
        want, _ = _run(None, cfg, dp, pm, SHORT)
        got, flags = _run(eng, cfg, dp, pm, SHORT)
        assert _same_state(got, want)
    (e,) = eng.entries.values()
    assert len(e.graphs) == 3 and len(e.rounds) == 2 and eng.captures == 1
    assert flags == [True] * SHORT


def test_replayed_trace_with_churn_faults_and_audit_equals_the_plain_run(
        monkeypatch):
    """`run_trace` with a churn schedule, a fault at every boundary and
    the audit on, its step replayed: every segment's snapshot and the
    final state float-hex equal to the plain run. Segments carry their
    state in; each segment's membership change and faults run outside
    the step."""
    d = get_design("mask").with_(epoch_cycles=EPOCH)
    sched = churn_schedule(3, 4, 3)
    plan = faults.random_plan(11, 4, 3, rate=1.0)
    kw = dict(seg_cycles=SEG, fault_plan=plan, audit=True, device="cpu",
              return_state=True)
    want = runner.run_trace(d, sched, **kw)
    eng = replay.Graphs(graph=ReplayGraph)
    flags = []

    def step(cfg, dp, pm, st, cycle):
        st, r = eng.step(cfg, dp, pm, st, cycle)
        flags.append(r)
        return st

    monkeypatch.setattr(runner, "step", step)
    monkeypatch.setattr(replay, "GRAPHS", eng)   # `simulate` detaches
    got = runner.run_trace(d, sched, **kw)
    assert len(got.segments) == len(want.segments) == 4
    assert all(_same_stats(a, b) for a, b in zip(got.segments,
                                                  want.segments))
    assert _same_state(got.final_state, want.final_state)
    # the key's first cycle, its capture and the epoch cycles run eagerly
    assert len(flags) == 4 * SEG
    assert flags.count(False) == 2 + 4 * SEG // EPOCH


@pytest.mark.parametrize("name,rounds", [("ideal", 1), ("mask", 1),
                                         ("pwc", 2)])
def test_each_round_launches_from_python_once_a_cycle(monkeypatch, name,
                                                      rounds):
    """`ops.fused_tlb_access` is called once a round a cycle, eager,
    captured or replayed, with its positional signature (7 tensors, the
    host time) and its keywords."""
    calls = []
    plain = fused_ops.fused_tlb_access

    def counted(*args, **kwargs):
        calls.append((len(args), args[7], sorted(kwargs)))
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_ops, "fused_tlb_access", counted)
    cfg = SimConfig(design=name, sim_cycles=6, device="cpu")
    dp = design_params(cfg.design)
    pm = torch.tensor(app_matrix(MIX))[None]
    eng = replay.Graphs(graph=ReplayGraph)
    _, flags = _run(eng, cfg, dp, pm, 6)
    assert flags == [False, False, True, True, True, True]
    assert calls == [(8, c + 1, ["n_waves", "track_asids"])
                     for c in range(6) for _ in range(rounds)]


def test_the_cache_by_key():
    """One entry per key, reused by a second pass of the key; another row
    count or another host knob is another key; past `maxsize` the least
    recently used goes. A pass's state is a copy: a later pass of the
    key leaves it as it was."""
    eng = replay.Graphs(graph=ReplayGraph, maxsize=2)
    cfg = SimConfig(design="gpu-mmu", sim_cycles=4, device="cpu")
    dp = design_params(cfg.design)

    def pm(rows, mix=MIX):
        return torch.tensor(app_matrix(mix))[None].repeat(rows, 1, 1)

    first, _ = _run(eng, cfg, dp, pm(2), 4)
    kept = memsys.map_state(torch.clone, first)
    assert eng.captures == 1 and len(eng.entries) == 1
    second, flags = _run(eng, cfg, dp, pm(2, ["MUM", "RED"]), 4)
    assert flags == [True] * 4 and eng.captures == 1
    assert _same_state(first, kept) and not _same_state(first, second)
    k2 = next(iter(eng.entries))
    _run(eng, cfg, dp, pm(3), 4)                     # rows
    assert len(eng.entries) == 2 and eng.captures == 2
    _run(eng, cfg, dp._replace(thres_max=7), pm(2), 4)   # a host knob
    assert len(eng.entries) == 2 and eng.captures == 3
    assert k2 not in eng.entries                          # evicted
    _, flags = _run(eng, cfg, dp, pm(2), 4)
    assert flags == [False, False, True, True] and eng.captures == 4
