"""The comparison that decides ``correct``, and the bridges between the
benchmark's inputs and the program's types.

The reference (reference/tick.py) runs in float64 with its QP solved to a
KKT certificate.  The control is the program with its float32 matrix
products in TF32 (``tf32``), one precision below what the configurations
state (float32 with TF32 off).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random

import torch

from ..reference import tick as R


class Worst:
    """The gaps of each compared number, lane by lane, over everything
    added: ``values`` holds for each its largest gap (``name``), the lane
    it was read on (``name.at``, the tag given), and quantiles of its
    lanes' gaps (``name.p50``, ``.p75``, ``.p90``, ``.p99``); a count holds
    its sum."""

    QUANTILES = (('p50', 0.5), ('p75', 0.75), ('p90', 0.9), ('p99', 0.99))

    def __init__(self):
        self.gaps, self.tags, self.counts = {}, {}, {}

    def add(self, name, got, ref, tags):
        """Each lane's widest |got - ref|, a lane tagged by ``tags`` (B,); a
        non-finite entry of ``got`` reads infinite."""
        gap = (got.to(torch.float64) - ref.to(torch.float64)).abs()
        gap = torch.where(torch.isfinite(gap), gap, torch.inf)
        self.gaps.setdefault(name, []).append(
            gap.flatten(1).amax(1).cpu())
        self.tags.setdefault(name, []).append(tags.cpu())

    def top(self, name, k):
        """The ``k`` widest gaps of ``name``: [(gap, tag)]."""
        gaps = torch.cat(self.gaps[name])
        tags = torch.cat(self.tags[name])
        best = torch.topk(gaps, min(k, gaps.numel())).indices
        return [(float(gaps[i]), int(tags[i])) for i in best]

    def count(self, name, mask):
        self.counts[name] = self.counts.get(name, 0.0) + float(mask.sum())

    @property
    def values(self):
        out = dict(self.counts)
        for name, parts in self.gaps.items():
            lanes = torch.cat(parts)
            out[name] = float(lanes.max())
            out[f'{name}.at'] = int(torch.cat(self.tags[name])[
                lanes.argmax()])
            finite = torch.where(torch.isfinite(lanes), lanes,
                                 torch.finfo(torch.float64).max)
            for tag, q in self.QUANTILES:
                out[f'{name}.{tag}'] = float(torch.quantile(finite, q))
        return out


class Reservoir:
    """A uniform sample of ``k`` of the items offered (reservoir
    sampling, its choices drawn from the seed); holds references, copies
    nothing."""

    def __init__(self, k, seed):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def sync(devices):
    for d in devices:
        if d.type == 'cuda':
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def tf32():
    """Float32 products in TF32 on the card: the program built and run
    inside is the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the program's types ----------------------------------------------------

def port_state(carry, plant, cfg):
    """The benchmark's (carry, plant) as the program's ControllerCarry and
    PlantState; the estimator carry, which no tick under the cheater reads,
    is the program's own initial one."""
    from hector_torch import control as C, mpc as M, runtime as RT
    from hector_torch import swing as SW
    from hector_torch.plant import srb
    pplant = srb.PlantState(*plant)
    est = RT.init_controller_carry(pplant, cfg).est
    pcarry = RT.ControllerCarry(
        tick=carry.tick, mode=carry.mode,
        planner=M.PlannerState(carry.world_position_desired, carry.f_ff),
        swing=SW.SwingState(*carry.swing),
        command=C.CommandState(carry.yaw_des), est=est)
    return pcarry, pplant


def port_command(cmd):
    from hector_torch import runtime as RT
    return RT.ScenarioCommand(*cmd)


def ref_command(pcmd):
    return R.Command(*pcmd)


def port_config(base, spec):
    """``base`` (the port's or the frozen HectorConfig) with the groups of
    a configuration file's ``solver`` and ``mpc`` put in; a key the
    config does not have raises."""
    groups = {}
    for group in ('solver', 'mpc'):
        current = getattr(base, group)
        fields = {f.name for f in dataclasses.fields(current)}
        values = spec.get(group, {})
        unknown = set(values) - fields
        if unknown:
            raise KeyError(f'{group}: no such setting {sorted(unknown)}')
        values = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items()}
        groups[group] = dataclasses.replace(current, **values)
    return dataclasses.replace(base, **groups)
