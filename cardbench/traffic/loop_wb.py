"""Traffic kind ``loop_wb``: the closed loop against the articulated
HECTOR, the controller on the robot the reference's own simulation
stands it on (tier 2), with pushes.

The ``loop`` kind with the articulated plant (this kind extends it): each
unit is one batch of ``periods`` MPC periods over ``batch`` lanes, each
period five 1 kHz ticks (one solve; four implicit substeps of the
articulated plant a tick; the NaN quarantine), driven as ``loop.SEGMENTS``
calls in turn of ``runtime.make_rollout_whole_body(periods //
loop.SEGMENTS, cfg, with_disturbance=True)`` with the production contact
model and substeps, whose period is captured once as a CUDA graph and
replayed.  Every batch starts from the articulated robot at rest at
0.545 m in the URDF's zero pose, with the ``loop`` kind's fresh commands
and pushes.  A unit ends when the batch's quarantined, fallen and
collapsed lanes have been counted on the host.

The check is the ``loop`` kind's with the articulated reference: from the
start of each later segment of the set-up's batch and of
``loop.CHECK_BATCHES`` window batches drawn from the seed, one reference
period (reference/whole_body.py's plant under reference/tick.py's
controller), every lane, against what the program's diagnostics record of
that segment's first period (the solve's wrench, the trunk's velocity
after it), and each segment's tick count exactly.

``failed`` counts the quarantined lanes; the shares of lanes fallen
(passive) and collapsed (the trunk below ``COLLAPSED_M``, whether or not
the controller's tilt check turned the lane passive) at a batch's end
are printed on standard error with the check.

Parameters (the mix's file): ``batch``, ``periods``, ``p_standing``,
``p_push``, ``push_n``, ``trace_units`` periods traced.
"""

from __future__ import annotations

import sys

import torch

from . import loop
from ..reference import tick as R
from ..reference import whole_body as RW
from ..yardstick import compare, scenarios as S

END_TO_END = loop.END_TO_END
START_HEIGHT = 0.545
COLLAPSED_M = 0.3


def port_state(carry, wb, cfg):
    """The benchmark's (carry, articulated plant) as the program's
    ControllerCarry and WholeBodyState."""
    from hector_torch.plant import whole_body as WB
    pcarry, _ = compare.port_state(carry, RW.observe(wb), cfg)
    return pcarry, WB.WholeBodyState(*wb)


def ref_state(pcarry, pwb, dtype):
    """The program's state as the reference's types, cast to ``dtype``."""
    carry, _ = S.from_port(pcarry, RW.observe(RW.State(*pwb)), dtype)
    return carry, S.cast_tree(RW.State(*pwb), dtype)


class Traffic(loop.Traffic):

    def __init__(self, mix, cfg, ref_cfg, seed, devices):
        from hector_torch import runtime as RT
        super().__init__(mix, cfg, ref_cfg, seed, devices)
        wb = RW.standing(self.batch, START_HEIGHT, torch.float32, self.dev)
        carry = R.first_carry(RW.observe(wb),
                              torch.zeros(self.batch, dtype=torch.int32,
                                          device=self.dev))
        self.state0 = port_state(carry, wb, cfg)
        self.roll = RT.make_rollout_whole_body(self.seg, cfg,
                                               with_disturbance=True)
        self.ends = [0, 0, 0]      # lanes fallen, collapsed; lanes

    def _batch(self, state):
        segments, state = super()._batch(state)
        carry, plant = state
        fallen, low = torch.stack([
            (carry.mode == R.PASSIVE).sum(),
            (plant.position[:, 2] < COLLAPSED_M).sum()]).tolist()
        for k, n in enumerate((fallen, low, self.batch)):
            self.ends[k] += n
        return segments, state

    def work(self):
        return {'lanes': self.batch,
                'plant_substeps': self.cfg.mpc.mpc_cadence
                * RW.N_SUBSTEPS}

    def check(self):
        """One whole period from each checked segment's start, against what
        the program's first period of that segment produced: its solve's
        wrench, and the trunk's velocity after it (the next period's
        observation); and the ticks the segment ran.  A lane is tagged
        segment x batch + lane."""
        fallen, low, seen = self.ends
        print(f'loop_wb: lanes at batch end {seen}: fallen (passive) '
              f'{fallen} ({100.0 * fallen / max(seen, 1):.3f} %), trunk '
              f'below {COLLAPSED_M} m {low} ({100.0 * low / max(seen, 1):.3f}'
              f' %); quarantined {self.failed_lanes}', file=sys.stderr,
              flush=True)
        worst = compare.Worst()
        ticks = self.seg * self.cfg.mpc.mpc_cadence
        lanes = torch.arange(self.batch, device=self.dev)
        segments = [s for b in [self.start] + self.samples.items for s in b]
        for k, (state_in, cmd, push, diags, state_out) in enumerate(segments):
            carry, wb = ref_state(*state_in, torch.float64)
            rcmd = S.cast_tree(compare.ref_command(cmd), torch.float64)
            _, ref_p, ref_t = RW.period(carry, wb, rcmd,
                                        push[:, 0].to(torch.float64),
                                        self.ref_cfg)
            v = torch.stack([diags['vx'][:, 1], diags['vy'][:, 1]], -1)
            tags = k * self.batch + lanes
            worst.add('wrench_gap_N', diags['wrench'][:, 0], ref_t.wrench,
                      tags)
            worst.add('v_gap_mps', v, ref_p.v_world[:, :2], tags)
            worst.count('tick_mismatch',
                        state_out[0].tick != carry.tick + ticks)
            worst.count('ref_uncertified', ~ref_t.certified)
        self.worst = worst
        return worst.values
