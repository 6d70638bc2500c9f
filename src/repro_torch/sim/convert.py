"""Carry simulator state between the reference and the port, via numpy.

For a simulator the "weights carried across" are its state. These pairs
turn a reference tree fetched to the host (`jax.device_get` of a
`repro.sim.memsys.SimState`, numpy leaves) into the port's tensors on a
device, and back. The port's NamedTuples have the reference's fields in
the reference's order, so the numpy trees also flatten identically.
Nothing here imports the reference: trees are read by field name.

A port state may carry a leading row axis (`memsys.init_state(cfg, dp,
rows=R)`); a reference state is one row. `state_to_numpy(st, row=r)`
gives row r shaped as the reference's state, `row_of` slices a row out
of a tree already on the host, and `state_from_numpy` stacks a list of
reference trees into a state with one row per tree.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.bypass import BypassState
from repro_torch.core.design import DesignParams
from repro_torch.core.dram_sched import DramState
from repro_torch.core.tlb import TLBState
from repro_torch.core.tokens import TokenState
from repro_torch.sim.memsys import (DataState, SimState, StatState,
                                   TransState, map_state)
from repro_torch.spans import span

# NamedTuple fields that are subtrees, by owning type
_SUBTREES = {
    SimState: {"trans": TransState, "data": DataState, "tokens": TokenState,
               "stats": StatState},
    TransState: {"l1": TLBState, "l2tlb": TLBState, "bypass_tlb": TLBState,
                 "pwc": TLBState},
    DataState: {"l2c": TLBState, "dram": DramState, "bypass": BypassState},
}


def _from_numpy(cls, tree, device):
    """One tree, or a list of trees stacked on a new leading row axis."""
    sub = _SUBTREES.get(cls, {})
    many = isinstance(tree, list)

    def field(f):
        return [getattr(x, f) for x in tree] if many else getattr(tree, f)

    return cls(*(
        _from_numpy(sub[f], field(f), device) if f in sub
        else torch.tensor(np.stack(field(f)) if many
                          else np.asarray(field(f)), device=device)
        for f in cls._fields))


def _to_numpy(tree):
    return map_state(lambda x: x.detach().cpu().numpy(), tree)


def row_of(tree, row: int):
    """Row `row` of a state with a row axis (tensor or numpy leaves)."""
    return map_state(lambda x: x[row], tree)


def state_from_numpy(tree, device) -> SimState:
    """A SimState-shaped tree of numpy leaves -> the port's SimState; a
    list of such trees -> a state with one row per tree, in order."""
    return _from_numpy(SimState, tree, device)


def state_to_numpy(state: SimState, row: Optional[int] = None) -> SimState:
    """The port's SimState -> the same NamedTuples with numpy leaves: the
    whole state, or row `row` of a state with a row axis (then shaped as
    the reference's). Each leaf is one synchronous copy; a pass's state
    has 51. Under the profiler the span `sim.to_host` carries the bytes
    copied and the copies made."""
    with span("sim.to_host") as attrs:
        tree = state if row is None else row_of(state, row)
        if attrs is not None:
            leaves: list = []
            map_state(leaves.append, tree)
            attrs["bytes"] = sum(x.numel() * x.element_size()
                                 for x in leaves)
            attrs["copies"] = len(leaves)
        return _to_numpy(tree)


def tlb_from_numpy(tree, device) -> TLBState:
    return _from_numpy(TLBState, tree, device)


def tlb_to_numpy(state: TLBState) -> TLBState:
    return _to_numpy(state)


def design_params_from_numpy(tree) -> DesignParams:
    """A reference DesignParams of 0-d arrays -> the port's host scalars."""
    kinds = {"initial_frac": np.float32, "step_frac": np.float32,
             "thres_max": int}
    return DesignParams(*(kinds.get(f, bool)(np.asarray(getattr(tree, f)))
                          for f in DesignParams._fields))


def design_params_to_numpy(dp: DesignParams) -> DesignParams:
    """The port's DesignParams -> 0-d numpy arrays of the reference's types."""
    types = {"initial_frac": np.float32, "step_frac": np.float32,
             "thres_max": np.int32}
    return DesignParams(*(np.asarray(v, types.get(f, np.bool_))
                          for f, v in zip(DesignParams._fields, dp)))


def params_mat_from_numpy(pm, device) -> torch.Tensor:
    """(n_apps, N_FIELDS) int32 workload parameter matrix (rows: (R,
    n_apps, N_FIELDS)) -> tensor."""
    return torch.tensor(np.asarray(pm, np.int32), device=device)


def params_mat_to_numpy(pm: torch.Tensor) -> np.ndarray:
    return pm.detach().cpu().numpy()
