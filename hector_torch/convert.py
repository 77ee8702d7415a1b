"""State carried across from the JAX package.

This system has no weights; what crosses between ``hector`` and
``hector_torch`` is state: ``PlantState``, ``WholeBodyState``,
``ControllerCarry`` (its ``EstimatorState.key`` as the two uint32 words of
the JAX key, in int64), ``ScenarioCommand``, ``StageQPParts``,
``StageQPData``, ``QPData``, the inputs of a rollout (a push,
``disturbance``, and a command/mode schedule), and the parameter tuples of
the sensor and contact models (``SensorNoise``, ``KFNoise``,
``ContactConfig``: Python floats, as in JAX).
A caller flattens a JAX pytree into a dict of numpy arrays keyed by the JAX
field names (nested NamedTuples as nested dicts); ``from_numpy(cls, arrays,
dtype, device)`` builds the port's NamedTuple ``cls`` from it (e.g.
``srb.PlantState``, ``runtime.ControllerCarry``, ``qp.riccati.StageQPData``).
``cls`` may also be ``torch.Tensor`` (one floating array, e.g. a
disturbance), an integer torch dtype (one integer array, e.g. the mode
commands) or a tuple of these (e.g. ``SCHEDULE``, a schedule given as
``(cmd_t dict, mode_cmd_t array)``).  Nothing here touches JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from . import control as C
from . import estimation as EST
from . import mpc as M
from . import swing as SW
from .plant import whole_body as WB
from .runtime import ControllerCarry, ScenarioCommand

# NamedTuple fields that hold NamedTuples
NESTED = {
    ControllerCarry: dict(planner=M.PlannerState, swing=SW.SwingState,
                          command=C.CommandState, est=EST.EstimatorState),
    EST.EstimatorState: dict(filt=EST.FilterState, kf=EST.KFState,
                             mahony=EST.MahonyState),
}
# a rollout schedule: (cmd_t, mode_cmd_t), runtime.make_rollout
SCHEDULE = (ScenarioCommand, torch.int32)
# NamedTuples of Python floats (model parameters, not state)
PARAMS = (EST.SensorNoise, EST.KFNoise, WB.ContactConfig)
# integer fields keep their integer type (the FSM counters are int32)
INT_FIELDS = {(ControllerCarry, 'tick'): torch.int32,
              (ControllerCarry, 'mode'): torch.int32,
              (EST.EstimatorState, 'key'): torch.int64}


def from_numpy(cls, arrays, dtype=torch.float32, device='cuda'):
    """Build ``cls`` (a port NamedTuple) from a dict of numpy arrays keyed
    by its field names, or a tensor or tuple as the module docstring says.
    Floating arrays become ``dtype``, booleans stay booleans, the integer
    counters keep their integer type."""
    dev = resolve_device(device)
    if isinstance(cls, tuple):
        return tuple(from_numpy(c, a, dtype, dev)
                     for c, a in zip(cls, arrays, strict=True))
    if cls is torch.Tensor:
        return torch.tensor(np.asarray(arrays), device=dev).to(dtype)
    if isinstance(cls, torch.dtype):
        return torch.tensor(np.asarray(arrays).astype(np.int64),
                            device=dev).to(cls)
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f'{cls.__name__}: missing fields {sorted(missing)}')
    if cls in PARAMS:
        return cls(*[float(arrays[name]) for name in cls._fields])
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
    field names, a plain tuple as a tuple, a tensor as an array: the
    inverse of :func:`from_numpy`."""
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {k: to_numpy(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
