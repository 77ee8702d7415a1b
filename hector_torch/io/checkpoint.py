"""Checkpoint / resume for batched runs (port of ``hector/io/checkpoint.py``,
orbax replaced by ``torch.save``/``torch.load``).

The reference has no state serialization (SURVEY.md §5).  Large scenario
batches need resumable state; this module checkpoints the full
(ControllerCarry, PlantState or WholeBodyState, ScenarioCommand) trees plus
step metadata, as the JAX module does: one directory per step under
``path``, the three newest kept, the newest restored by default.

Each step's file holds nested dicts of tensors keyed by field names (no
pickled classes, so it loads with ``weights_only=True``); :func:`restore`
rebuilds the NamedTuples from a template and puts every tensor on the
template's device and dtype.  A file is written under a temporary name
and moved into place with ``os.replace``, so a step directory never holds
half a checkpoint.  Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

FILE = 'state.pt'


def _to_dict(tree):
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return {k: _to_dict(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _from_dict(data, template):
    if isinstance(template, tuple) and hasattr(template, '_fields'):
        return type(template)(*[_from_dict(data[k], getattr(template, k))
                                for k in template._fields])
    if isinstance(template, torch.Tensor):
        return data.to(device=template.device, dtype=template.dtype)
    return data


def steps(path: str):
    """The checkpointed steps under ``path``, oldest first."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.isfile(os.path.join(path, d,
                                                                 FILE)))


def save(path: str, step: int, carry, plant, cmd,
         extra: Optional[dict] = None, max_to_keep: int = 3) -> None:
    """Checkpoint the rollout state at ``step`` (MPC periods completed),
    then drop all but the ``max_to_keep`` newest steps."""
    step_dir = os.path.join(path, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    state = dict(step=int(step), carry=_to_dict(carry),
                 plant=_to_dict(plant), cmd=_to_dict(cmd),
                 extra=_to_dict(extra or {}))
    tmp = os.path.join(step_dir, f'{FILE}.{os.getpid()}.tmp')
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(step_dir, FILE))
    for old in steps(path)[:-max_to_keep]:
        shutil.rmtree(os.path.join(path, str(old)))


def restore(path: str, template, step: Optional[int] = None
            ) -> Tuple[int, Any]:
    """Restore (step, {carry, plant, cmd, extra}) at ``step`` (default the
    newest).

    template: (carry, plant, cmd) of the same structure (e.g. a freshly
    built batch); the restored tensors take its devices and dtypes."""
    if step is None:
        have = steps(path)
        if not have:
            raise FileNotFoundError(f'no checkpoint under {path}')
        step = have[-1]
    file = os.path.join(path, str(int(step)), FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f'no checkpoint of step {step} under {path}')
    data = torch.load(file, map_location='cpu', weights_only=True)
    restored = dict(carry=_from_dict(data['carry'], template[0]),
                    plant=_from_dict(data['plant'], template[1]),
                    cmd=_from_dict(data['cmd'], template[2]),
                    extra=data['extra'])
    return data['step'], restored
