"""Traffic kind ``loop``: the tier-1 closed loop with pushes, the
robustness battery users run.

Each unit is one batch of ``periods`` MPC periods over ``batch`` lanes,
each period five 1 kHz ticks (one solve, five plant steps, the NaN
quarantine): ``SEGMENTS`` calls in turn of ``runtime.make_rollout(periods
// SEGMENTS, cfg, with_disturbance=True)``, each from the state the last
one returned, whose period is captured once as a CUDA graph and replayed.
Every batch starts from the standing pose with fresh commands over the
teleop envelope and a fresh push schedule (``p_push`` a lane-period,
``push_n`` N) from the seed and the batch's index.  A unit ends when the
batch's quarantine count has been read on the host.

A rollout returns its state after its last period only; the segments make
the states at their boundaries, which the timed path reached mid-walk,
the starts of the periods the check recomputes: the first period of each
later segment, against what the program's diagnostics record of it (the
solve's wrench, the trunk after it).  The first segment's start, the
standing pose, is the benchmark's own input; each segment's tick count is
held exactly.

The check takes the set-up's batch and ``CHECK_BATCHES`` window batches
drawn from the seed, every lane.

Parameters (the mix's file): ``batch``, ``periods``, ``p_standing``,
``p_push``, ``push_n``, ``trace_units`` periods traced.
"""

from __future__ import annotations

import time

import torch

from ..reference import tick as R
from ..yardstick import compare, scenarios as S

END_TO_END = ('loop_lane_s_per_s',)
SEGMENTS = 2
CHECK_BATCHES = 4


class Traffic:

    def __init__(self, mix, cfg, ref_cfg, seed, devices):
        from hector_torch import runtime as RT
        self.mix, self.cfg, self.ref_cfg, self.seed = mix, cfg, ref_cfg, seed
        self.dev = devices[0]
        self.batch = mix['batch']
        self.periods = mix['periods']
        self.period_s = cfg.mpc.dt * cfg.mpc.mpc_cadence
        carry, plant = S.standing_state(self.batch, torch.float32, self.dev)
        self.state0 = compare.port_state(carry, plant, cfg)
        self.seg = self.periods // SEGMENTS
        self.roll = RT.make_rollout(self.seg, cfg, with_disturbance=True)
        self.index = 0
        self.failed_lanes = 0
        self.samples = compare.Reservoir(CHECK_BATCHES, seed)

    def inputs(self, b):
        """Batch b's commands (the program's type) and pushes."""
        g = S.generator(self.seed, b + 1, self.dev)
        cmd = S.commands(g, self.batch, self.mix['p_standing'],
                         torch.float32, self.dev)
        push = S.pushes(g, self.batch, self.periods, self.mix['push_n'],
                        self.mix['p_push'], torch.float32, self.dev)
        return compare.port_command(cmd), push

    def _batch(self, state):
        """The segments of one batch from ``state``: ([(start, cmd, its
        pushes, diagnostics, end)] for the segments after the first), the
        end state."""
        cmd, push = self.inputs(self.index)
        self.index += 1
        segments, quarantined = [], 0
        for k in range(SEGMENTS):
            seg_push = push[:, k * self.seg:(k + 1) * self.seg]
            carry, plant, diags = self.roll(*state, cmd, seg_push)
            quarantined = quarantined + diags['quarantined'].sum()
            if k:
                segments.append((state, cmd, seg_push, diags,
                                 (carry, plant)))
            state = (carry, plant)
        self.failed_lanes += int(quarantined)
        return segments, state

    def warm(self):
        """Capture the period and run the first batch (always checked)."""
        self.start, self.state = self._batch(self.state0)

    def unit(self):
        """One batch: (seconds, lane-seconds simulated)."""
        t0 = time.perf_counter()
        sample, self.state = self._batch(self.state0)
        dt = time.perf_counter() - t0
        self.samples.offer(sample)
        return dt, self.batch * self.periods * self.period_s

    def failed(self):
        return self.failed_lanes

    def attempted(self, work):
        return round(work / self.period_s)

    @staticmethod
    def end_to_end(latencies, work, window_s):
        return {'loop_lane_s_per_s': (work / window_s, 'lane-s/s')}

    # -- the traced run ----------------------------------------------------

    def traced(self, n):
        """A function that replays ``n`` single periods of the window's own
        capture, from the state the window left."""
        cap, = self.roll.graphed.captures.values()
        cmd, push = self.inputs(self.index)
        cap.load(self.state, {'cmd': cmd,
                              'disturbance': push[:, :self.seg]})

        def run():
            for _ in range(n):
                cap.replay()
            compare.sync([self.dev])
        return run

    def work(self):
        return {'lanes': self.batch}

    # -- the check ---------------------------------------------------------

    def release(self):
        self.roll = None
        self.state = None

    def check(self):
        """One whole period from each checked segment's start, against what
        the program's first period of that segment produced: its solve's
        wrench, and the trunk's velocity after it (the next period's
        observation); and the ticks the segment ran.  A lane is tagged
        segment x batch + lane."""
        worst = compare.Worst()
        ticks = self.seg * self.cfg.mpc.mpc_cadence
        lanes = torch.arange(self.batch, device=self.dev)
        segments = [s for b in [self.start] + self.samples.items for s in b]
        for k, (state_in, cmd, push, diags, state_out) in enumerate(segments):
            carry, plant = S.from_port(*state_in, torch.float64)
            rcmd = S.cast_tree(compare.ref_command(cmd), torch.float64)
            _, ref_p, ref_t = R.period(carry, plant, rcmd,
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
