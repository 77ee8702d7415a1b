"""Traffic kind ``plan``: the receding-horizon planning step.

Each unit is one batched planning step of the port (``runtime.plan_step_fn``:
FK and Jacobians, gait, reference trajectory, QP build, solve, wrench and
torque map), captured once as a ``graph.StepGraph`` of one step and
replayed, chained: the step's state goes into the next call, and each step
moves the trunk position by 1e-9 x its first leg's force, as the port's
bench.py chain does, so that no step can be skipped.  A unit ends when the
step's wrench has been copied into host memory: the caller of an MPC hands
in the state each period and takes the plan back.

Lanes start at the standing pose with a trunk velocity inside the teleop
envelope, an attitude within +-0.1 rad and a gait tick drawn over the
gait's 10 segments, and carry commands drawn over the envelope
(yardstick/scenarios.py), all from the seed.

The check takes the first step (from the benchmark's own state) and
``CHECK_STEPS`` window steps drawn from the seed, ``CHECK_LANES`` lanes of
each, and holds the step's wrench and torques to the reference's from the
step's own input state.

Parameters (the mix's file): ``batch`` lanes a step, ``p_standing``,
``trace_units`` steps traced, and ``freeze_iterations``, the mean
iteration at which the fused kernel's lanes of this mix freeze (the
roofline's operation count; measured once, PERF.md), where the fused
kernel runs.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..reference import tick as R
from ..yardstick import compare, scenarios as S
from ..yardstick import workcounts as W

END_TO_END = ('plan_solves_per_s', 'dense_plan_solves_per_s',
              'plan_step_ms_p95')
CHECK_STEPS = 6
CHECK_LANES = 4096


class Traffic:

    def __init__(self, mix, cfg, ref_cfg, seed, devices):
        from hector_torch import graph
        from hector_torch import runtime as RT
        self.mix, self.cfg, self.ref_cfg, self.seed = mix, cfg, ref_cfg, seed
        self.dev = devices[0]
        self.batch = batch = mix['batch']
        g = S.generator(seed, 0, self.dev)
        carry, plant = S.moving_state(g, batch, torch.float32, self.dev)
        cmd = S.commands(g, batch, mix['p_standing'], torch.float32,
                         self.dev)
        self.state0 = compare.port_state(carry, plant, cfg)
        self.cmd = compare.port_command(cmd)
        plan = RT.plan_step_fn(cfg)

        def step(state, cmd, i):
            carry, plant = state
            carry, wrench, motor = plan(carry, plant, cmd)
            plant = plant._replace(
                position=plant.position + 1e-9 * wrench[:, 0, :3])
            return (carry, plant), {'wrench': wrench, 'tau': motor.tau}

        self.steps = graph.StepGraph(step, 1)
        self.host = torch.empty((batch, 2, 6), dtype=torch.float32,
                                pin_memory=self.dev.type == 'cuda')
        self.bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.samples = compare.Reservoir(CHECK_STEPS, seed)

    # -- the timed path ----------------------------------------------------

    def _call(self, state):
        state_out, outs = self.steps(state, self.cmd)
        outs = {k: v[:, 0] for k, v in outs.items()}
        self.host.copy_(outs['wrench'], non_blocking=True)
        if self.dev.type == 'cuda':
            torch.cuda.current_stream(self.dev).synchronize()
        return state_out, outs

    def warm(self):
        """Capture the step and run it from the benchmark's own state (the
        start, always checked), then two more steps, so that every shape
        the window uses is built."""
        out, outs = self._call(self.state0)
        self.start = (self.state0, outs, out)
        for _ in range(2):
            out, _ = self._call(out)
        self.state = out

    def unit(self):
        """One planning step: (seconds from issue to the wrench on the
        host, lane-steps)."""
        t0 = time.perf_counter()
        state_in = self.state
        state_out, outs = self._call(state_in)
        dt = time.perf_counter() - t0
        w = outs['wrench']
        self.bad += (~torch.isfinite(w).flatten(1).all(1)).sum()
        self.state = state_out
        self.samples.offer((state_in, outs, state_out))
        return dt, self.batch

    def failed(self):
        return int(self.bad)

    def attempted(self, work):
        return int(work)

    @staticmethod
    def end_to_end(latencies, work, window_s):
        p95 = (statistics.quantiles(latencies, n=100)[94]
               if len(latencies) > 1 else latencies[0])
        # the dense path's rate is a metric of its own, so that its host
        # phases do not set the bound of the fused cells' rate
        return {'plan_solves_per_s': (work / window_s, 'solves/s'),
                'dense_plan_solves_per_s': (work / window_s, 'solves/s'),
                'plan_step_ms_p95': (1e3 * p95, 'ms')}

    # -- the traced run ----------------------------------------------------

    def traced(self, n):
        """A function that runs ``n`` units of the window for the trace."""
        def run():
            for _ in range(n):
                self.unit()
        self.traced_units = n
        return run

    def work(self):
        """What the rooflines divide by, for the traced steps: the fused
        solver's operations at the mix's frozen freeze iteration and its
        bytes, and the batch's lanes."""
        out = {'lanes': self.batch}
        if self.cfg.solver.polish_rounds == 0 and \
                _fused(self.cfg, self.dev) and 'freeze_iterations' in self.mix:
            steps = self.traced_units * self.batch
            out['fused_operations'] = steps * W.operations(
                self.mix['freeze_iterations'])
            out['fused_bytes'] = steps * W.bytes_per_scenario()
        if _dense(self.cfg, self.dev):
            out['kkt_n'] = 12 * self.cfg.mpc.horizon
        return out

    # -- the check ---------------------------------------------------------

    def release(self):
        """Free what only the timed path needed before the reference runs."""
        self.steps = None
        self.state = None

    def steps_checked(self):
        """[(input state, outputs, output state)] of the checked steps."""
        return [self.start] + self.samples.items

    def lanes_checked(self):
        gen = S.generator(self.seed, 1 << 20, 'cpu')
        n = min(CHECK_LANES, self.batch)
        return torch.randperm(self.batch, generator=gen)[:n].to(self.dev)

    def check(self):
        """The compared numbers over the checked steps and lanes; a lane is
        tagged step x batch + lane."""
        lanes = self.lanes_checked()
        worst = compare.Worst()
        for k, (state_in, outs, state_out) in enumerate(self.steps_checked()):
            carry, plant = S.from_port(*S.take(state_in, lanes),
                                       torch.float64)
            cmd = S.cast_tree(S.take(compare.ref_command(self.cmd), lanes),
                              torch.float64)
            ref = R.controller_tick(carry, plant, cmd, True, self.ref_cfg)
            tags = k * self.batch + lanes
            worst.add('wrench_gap_N', outs['wrench'][lanes], ref.wrench, tags)
            worst.add('tau_gap_Nm', outs['tau'][lanes], ref.motor.tau, tags)
            worst.count('tick_mismatch',
                        state_out[0].tick[lanes] != ref.carry.tick)
            worst.count('ref_uncertified', ~ref.certified)
        self.worst = worst
        return worst.values


def _fused(cfg, dev):
    from hector_torch import mpc as M
    return M.resolve_backend(cfg.solver.backend, dev) == 'riccati_pallas'


def _dense(cfg, dev):
    from hector_torch import mpc as M
    return M.resolve_backend(cfg.solver.backend, dev) in M.DENSE_BACKENDS
