"""State carried across from the JAX package.

This system has no weights; what crosses between ``hector`` and
``hector_torch`` is state: ``PlantState``, ``ControllerCarry``,
``ScenarioCommand`` and ``StageQPParts``.  A caller flattens a JAX pytree
into a dict of numpy arrays keyed by the JAX field names (nested
NamedTuples as nested dicts); ``from_numpy(cls, arrays, dtype, device)``
builds the port's NamedTuple ``cls`` from it (e.g. ``srb.PlantState``,
``runtime.ControllerCarry``).  Nothing here touches JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from . import control as C
from . import estimation as EST
from . import mpc as M
from . import swing as SW
from .runtime import ControllerCarry

# NamedTuple fields that hold NamedTuples
NESTED = {
    ControllerCarry: dict(planner=M.PlannerState, swing=SW.SwingState,
                          command=C.CommandState, est=EST.EstimatorState),
    EST.EstimatorState: dict(filt=EST.FilterState, kf=EST.KFState,
                             mahony=EST.MahonyState),
}
# integer fields keep their integer type (the FSM counters are int32)
INT_FIELDS = {(ControllerCarry, 'tick'): torch.int32,
              (ControllerCarry, 'mode'): torch.int32,
              (EST.EstimatorState, 'key'): torch.int64}


def from_numpy(cls, arrays: dict, dtype=torch.float32, device='cuda'):
    """Build ``cls`` (a port NamedTuple) from a dict of numpy arrays keyed
    by its field names.  Floating arrays become ``dtype``, booleans stay
    booleans, the integer counters keep their integer type."""
    dev = resolve_device(device)
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f'{cls.__name__}: missing fields {sorted(missing)}')
    out = []
    for name in cls._fields:
        value = arrays[name]
        sub = NESTED.get(cls, {}).get(name)
        if sub is not None:
            out.append(from_numpy(sub, value, dtype, dev))
            continue
        arr = np.asarray(value)
        if arr.dtype == np.bool_:
            t_dtype = torch.bool
        else:
            t_dtype = INT_FIELDS.get((cls, name), dtype)
            if not t_dtype.is_floating_point:
                arr = arr.astype(np.int64)
        out.append(torch.tensor(arr, device=dev).to(t_dtype))
    return cls(*out)


def to_numpy(tree):
    """A port NamedTuple (nested allowed) as a dict of numpy arrays keyed by
    field names, the inverse of :func:`from_numpy`."""
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {k: to_numpy(v) for k, v in zip(tree._fields, tree)}
    return tree.detach().cpu().numpy()
