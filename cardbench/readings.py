"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m cardbench.readings --workload <cell> --seeds 1 2 3 ... \\
        [--seconds 3] [--control 1] [--witness 0] [--freeze 0]

For each seed, in one process: the cell's traffic at its own size, set up
and driven for ``--seconds`` as a run drives it, then the numbers a run
compares; with ``--control 1`` the same again for the control, the
program built and run with its float32 products in TF32.  One JSON line a
seed; the limits lie between the program's largest and the control's
smallest (PERF.md gives the readings and the limits).

``--witness k`` (planning cells) also solves the ``k`` lanes with the
widest force gap again with the program's own other paths: the fused
interior point's plain version in float32 and in float64 (at the
configured iterations and at 40), the stage solver and the dense
interior point in float64; each beside the reference.  ``--units n`` drives n units in place of ``--seconds``, so
that a seed samples the same steps again.  ``--freeze 1``
(planning cells on the fused kernel) gives the mean iteration at which
the kernel's lanes freeze on the checked steps, the roofline's frozen
operation count (the mix's ``freeze_iterations``).
"""

import argparse
import dataclasses
import gc
import json
import sys
import time

import torch


def _drive(kind, mix, cfg, ref_cfg, seed, devices, seconds, n_units=None):
    traffic = kind.Traffic(mix, cfg, ref_cfg, seed, devices)
    traffic.warm()
    t0 = time.perf_counter()
    units = 0
    while (units < n_units if n_units else
           time.perf_counter() - t0 < seconds):
        traffic.unit()
        units += 1
    traffic.release()
    gc.collect()
    return traffic, units


def witness(traffic, tags, cfg):
    """For each tagged lane of a planning cell: its gaps to the reference
    of the program, of the fused interior point's plain version in float32
    and in float64 (the configured iterations, and 40), of the stage
    solver and of the dense interior point in float64; and what the lane
    was doing."""
    from hector_torch import runtime as RT
    from .reference import tick as R
    from .yardstick import compare, scenarios as S
    steps = traffic.steps_checked()
    out = []
    for tag in tags:
        k, lane = divmod(tag, traffic.batch)
        state_in, outs, _ = steps[k]
        idx = torch.tensor([lane], device=traffic.dev)
        pstate = S.cast_tree(S.take(state_in, idx), torch.float64)
        pcmd = S.cast_tree(S.take(traffic.cmd, idx), torch.float64)
        carry, plant = S.from_port(*pstate)
        ref = R.controller_tick(carry, plant, compare.ref_command(pcmd),
                                True, traffic.ref_cfg)
        rec = {'tag': tag, 'step': k, 'tick': int(carry.tick[0]),
               'standing': bool(pcmd.gait_durations[0, 0] == 10),
               'stance': ref.stance[0].tolist(),
               'certified': bool(ref.certified[0]),
               'program_N': float((outs['wrench'][lane].double()
                                   - ref.wrench[0]).abs().max()),
               'ref_wrench': ref.wrench[0].tolist(),
               'program_wrench': outs['wrench'][lane].tolist()}
        pstate32 = S.cast_tree(pstate, torch.float32)
        pcmd32 = S.cast_tree(pcmd, torch.float32)
        c = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, backend='riccati_pallas_interpret'))
        _, w, _ = RT.plan_step_fn(c)(*pstate32, pcmd32)
        rec['fused32_N'] = float((w[0].double() - ref.wrench[0]).abs().max())
        for name, backend, iters in (
                ('fused64', 'riccati_pallas_interpret',
                 cfg.solver.iterations),
                ('fused64_40', 'riccati_pallas_interpret', 40),
                ('stage64', 'riccati', cfg.solver.iterations),
                ('dense64', 'xla', cfg.solver.iterations)):
            c = dataclasses.replace(cfg, solver=dataclasses.replace(
                cfg.solver, backend=backend, iterations=iters))
            _, w, _ = RT.plan_step_fn(c)(*pstate, pcmd)
            rec[f'{name}_N'] = float((w[0] - ref.wrench[0]).abs().max())
        out.append(rec)
    return out


def freeze_iterations(traffic):
    """The mean iteration at which the fused kernel's lanes freeze (the
    first whose answer the next iteration leaves unchanged bit for bit, as
    chip_smoke.py finds it), over the checked steps' lanes.  The QPs are
    caught at the solver's entry in one eager step of the program."""
    from hector_torch import runtime as RT
    from hector_torch.qp import fused_riccati as FR
    solve = FR.solve_parts
    total, lanes = 0.0, 0
    for state_in, _, _ in traffic.steps_checked():
        caught = []

        def catch(parts, scfg, q_diag, r_diag):
            caught.append((parts, scfg, q_diag, r_diag))
            return solve(parts, scfg, q_diag, r_diag)
        FR.solve_parts = catch
        try:
            RT.plan_step_fn(traffic.cfg)(*state_in, traffic.cmd)
        finally:
            FR.solve_parts = solve
        (parts, scfg, q_diag, r_diag), = caught
        n = scfg.iterations
        sols = [solve(parts, dataclasses.replace(scfg, iterations=i),
                      q_diag, r_diag).u for i in range(n + 1)]
        frozen = torch.full((parts.x0.shape[0],), float(n),
                            device=parts.x0.device)
        for i in range(n - 1, -1, -1):
            frozen = torch.where((sols[i + 1] == sols[i]).all(1),
                                 torch.full_like(frozen, i), frozen)
        total += float(frozen.sum())
        lanes += frozen.numel()
    return total / lanes


def readings(workload, seeds, seconds, device='cuda', log=sys.stdout,
             mix_update=None, control=True, n_witness=0, freeze=False,
             n_units=None):
    from . import run as CR
    from .yardstick import compare
    _, cell, mix, cfg, ref_cfg, kind, devices = CR.cell_parts(workload,
                                                              device)
    mix = dict(mix, **(mix_update or {}))
    out = []
    for seed in seeds:
        traffic, units = _drive(kind, mix, cfg, ref_cfg, seed, devices,
                                seconds, n_units)
        t0 = time.perf_counter()
        rec = {'workload': workload, 'seed': seed, 'units': units,
               'program': traffic.check(),
               'check_s': time.perf_counter() - t0,
               'limits': cell['limits']}
        if n_witness:
            worst = traffic.worst.top('wrench_gap_N', n_witness)
            rec['witness'] = witness(traffic, [t for _, t in worst], cfg)
        if freeze:
            rec['freeze_iterations'] = freeze_iterations(traffic)
        del traffic
        if control:
            with compare.tf32():
                traffic, _ = _drive(kind, mix, cfg, ref_cfg, seed, devices,
                                    seconds, n_units)
            rec['control'] = traffic.check()
            del traffic
        print(json.dumps(rec), file=log, flush=True)
        out.append(rec)
        gc.collect()
        if device == 'cuda':
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--control', type=int, default=1)
    p.add_argument('--witness', type=int, default=0)
    p.add_argument('--freeze', type=int, default=0)
    p.add_argument('--units', type=int, default=0,
                   help='drive this many units instead of --seconds, so '
                   'that a seed samples the same steps again')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('cardbench.readings: no CUDA device', file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.seconds,
             control=bool(args.control), n_witness=args.witness,
             freeze=bool(args.freeze), n_units=args.units or None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
