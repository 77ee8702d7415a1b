"""Drive the PyTorch port (hector_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  build   compile hector_torch/csrc/fused_riccati.cu for sm_90a (nvcc) and
          report its registers and spills;
  kernel  the fused Riccati kernel against its plain PyTorch version on the
          same QPs (closed-loop walking/standing states from a numpy seed,
          a ragged batch and the full 32,768-lane batch), max |du| <= 2e-4 N,
          and both timed at 32,768 lanes;
  check   one planning step on the card against the same step on the CPU
          (the plain solver) on 256 closed-loop lanes;
  main    runtime.plan_step_fn at 32,768 lanes, 16 chained steps as
          bench.py chains them, counting kernel launches;
  loop    runtime.make_rollout for 200 MPC periods (1 s) at 1,024 lanes,
          half walking at 0.5 m/s, half standing: no fall, no quarantine,
          height in the band tests/test_closedloop.py asserts;
then the kernels line, the card's name and power limit, and the result
line.  Any failure raises, so the exit code is not 0 and no result line is
printed.  Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 2e-4     # N, the bar tests/test_pallas_riccati.py holds the TPU kernel body to
STEP_TOL = 1e-2       # N, card vs CPU planning step (f32 IP accuracy floor, tests/test_riccati.py)
MAIN_BATCH = 32768    # bench.py:54
MAIN_CHAIN = 16
LOOP_BATCH = 1024
LOOP_PERIODS = 200
FP32_PEAK = 67e12     # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scenarios(batch, seed, device, periods=20):
    """Closed-loop controller states: lanes start standing at a random gait
    tick, half are commanded to walk at random speeds and half to stand,
    and the port's own tier-1 loop runs them for ``periods`` MPC periods.
    The QPs the planner builds there are the operating envelope the solver
    serves (wildly perturbed states give near-degenerate QPs on which any
    two float32 solvers drift apart by up to ~1e-2 N)."""
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG

    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t(x):
        return torch.tensor(x, dtype=f32, device=device)

    n_walk = batch // 2
    plant = srb.init_plant_state(batch, CFG, dtype=f32, device=device)
    carry = RT.init_controller_carry(plant, CFG)
    carry = carry._replace(tick=torch.tensor(
        rng.integers(0, 400, batch), dtype=torch.int32, device=device))
    walk = RT.walking_command(n_walk, dtype=f32, device=device)
    walk = walk._replace(vx=t(rng.uniform(-0.25, 0.75, n_walk)),
                         vy=t(rng.uniform(-0.1, 0.1, n_walk)))
    cmd = RT.concat(walk, RT.standing_command(batch - n_walk, f32, device))
    carry, plant, _ = RT.make_rollout(periods, CFG)(carry, plant, cmd)
    return carry, plant, cmd


def scenario_parts(batch, seed, device):
    """The StageQPParts one planning step builds from scenarios(); the same
    preamble as runtime.controller_tick up to the QP."""
    from hector_torch import control as C, gait as G, mpc as M
    from hector_torch.config import DEFAULT_CONFIG as CFG, JOINT_OFFSETS
    from hector_torch.kinematics import foot_position
    from hector_torch.runtime import N_SEGMENTS

    carry, plant, cmd = scenarios(batch, seed, device)
    est = C.estimate_state(plant.position, plant.v_world, plant.quat,
                           plant.omega_world)
    q_data = plant.q + torch.tensor(JOINT_OFFSETS, dtype=plant.q.dtype,
                                    device=device)
    v_des = torch.stack([cmd.vx, cmd.vy, torch.zeros_like(cmd.vx)], -1)
    planner, _ = M.integrate_position_setpoint(carry.planner, est, v_des, CFG)
    p_foot_w = M.foot_positions_world(est, foot_position(plant.q, CFG), CFG)
    iteration, _ = G.phase_state(carry.tick, CFG.mpc.iterations_between_mpc,
                                 N_SEGMENTS)
    gait = G.mpc_gait_table(iteration, cmd.gait_offsets, cmd.gait_durations,
                            N_SEGMENTS).to(plant.position.dtype)
    _, parts = M.build_parts(planner, est, q_data, p_foot_w, v_des,
                             cmd.yaw_rate, cmd.roll, cmd.pitch, gait, CFG)
    return parts


def to_cpu(tree):
    return type(tree)(*[to_cpu(x) if isinstance(x, tuple) else x.cpu()
                        for x in tree])


def parse_ptxas(text):
    """Registers, stack frame and spill bytes from nvcc -Xptxas -v."""
    out = {}
    for line in text.splitlines():
        if 'Used ' in line:
            out['registers'] = int(line.split('Used ')[1].split()[0])
        if 'spill stores' in line:
            fields = [f.split()[0] for f in line.strip().split(',')]
            out['stack_frame_bytes'] = int(fields[0])
            out['spill_store_bytes'] = int(fields[1])
            out['spill_load_bytes'] = int(fields[2])
    return out


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.qp import fused_riccati as FR

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    scfg = CFG.solver
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)

    # ---- build ----
    t0 = time.perf_counter()
    FR.build()
    build_s = time.perf_counter() - t0
    emit(dict(phase='build', seconds=build_s, card=card,
              nvcc_seconds=FR.build_info.get('seconds'),
              ptxas=parse_ptxas(FR.build_info.get('ptxas', '')),
              attributes=FR.kernel_attributes()))

    # ---- kernel vs plain version ----
    max_err = 0.0
    for batch, seed in ((4096, 1), (4099, 2), (MAIN_BATCH, 3)):
        parts = scenario_parts(batch, seed, dev)
        sol_k = FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)
        sol_p = FR.solve_parts_plain(parts, scfg, q_diag, r_diag)
        torch.cuda.synchronize()
        err = float((sol_k.u - sol_p.u).abs().max())
        stats = torch.stack([sol_k.mu, sol_k.r_dual, sol_k.r_prim])
        emit(dict(phase='kernel', batch=batch, max_abs_du=err,
                  max_mu=float(sol_k.mu.max()),
                  max_r_prim=float(sol_k.r_prim.max()),
                  u_scale=float(sol_p.u.abs().max())))
        if not (math.isfinite(err) and bool(torch.isfinite(stats).all())):
            raise RuntimeError(f'kernel output not finite at batch {batch}')
        if err > KERNEL_TOL:
            raise RuntimeError(f'kernel vs plain max |du| {err} N > '
                               f'{KERNEL_TOL} N at batch {batch}')
        max_err = max(max_err, err)
    kernel_ms = cuda_ms(
        lambda: FR.solve_parts_cuda(parts, scfg, q_diag, r_diag), 10)
    plain_ms = cuda_ms(
        lambda: FR.solve_parts_plain(parts, scfg, q_diag, r_diag), 2)
    ops = FR.op_count(scfg.iterations)
    n_ops = ops['flop'] + ops['div'] + ops['sqrt']
    ops_ms = MAIN_BATCH * n_ops / FP32_PEAK * 1e3
    bytes_ms = MAIN_BATCH * FR.bytes_per_scenario() / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    emit(dict(phase='kernel_time', batch=MAIN_BATCH, ms=kernel_ms,
              plain_ms=plain_ms, bound_ms=bound_ms, ops_ms=ops_ms,
              bytes_ms=bytes_ms, ops_per_scenario=ops,
              bytes_per_scenario=FR.bytes_per_scenario(),
              share_of_bound=bound_ms / kernel_ms, card=card))

    # ---- card vs CPU on one planning step ----
    carry, plant, cmd = scenarios(256, 4, dev)
    plan = RT.plan_step_fn(CFG)
    _, w_gpu, m_gpu = plan(carry, plant, cmd)
    _, w_cpu, m_cpu = plan(to_cpu(carry), to_cpu(plant), to_cpu(cmd))
    step_err = max(float((w_gpu.cpu() - w_cpu).abs().max()),
                   float((m_gpu.tau.cpu() - m_cpu.tau).abs().max()))
    emit(dict(phase='check', batch=256, max_abs_diff=step_err,
              wrench_scale=float(w_cpu.abs().max())))
    if not (math.isfinite(step_err) and step_err <= STEP_TOL):
        raise RuntimeError(f'card vs CPU planning step differs by {step_err}')

    # ---- main path: chained planning steps at full width ----
    plant = srb.init_plant_state(MAIN_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.walking_command(MAIN_BATCH, vx=0.5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    plant = plant._replace(position=plant.position + 1e-6 * torch.rand(
        plant.position.shape, generator=gen, device=dev))

    def chain(c, p, n):
        for _ in range(n):
            c, wrench, motor = plan(c, p, cmd)
            # chain: the next state depends on this step's QP solution
            p = p._replace(position=p.position + 1e-9 * wrench[:, 0, :3])
        return c, p, wrench, motor

    chain(carry, plant, 2)              # warm-up, not counted
    torch.cuda.synchronize()
    FR.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    c, p, wrench, motor = chain(carry, plant, MAIN_CHAIN)
    end.record()
    torch.cuda.synchronize()
    main_launches = FR.launches
    step_ms = start.elapsed_time(end) / MAIN_CHAIN
    if main_launches != MAIN_CHAIN:
        raise RuntimeError(f'main path launched the kernel {main_launches} '
                           f'times, expected {MAIN_CHAIN}')
    for name, x in (('wrench', wrench), ('tau', motor.tau),
                    ('f_ff', c.planner.f_ff), ('position', p.position)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'main path output {name} not finite')
    emit(dict(phase='main', batch=MAIN_BATCH, chain=MAIN_CHAIN,
              launches=main_launches, ms_per_step=step_ms,
              solves_per_s=MAIN_BATCH / step_ms * 1e3, card=card))

    # ---- tier-1 closed loop ----
    half = LOOP_BATCH // 2
    plant = srb.init_plant_state(LOOP_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.concat(RT.walking_command(half, vx=0.5, device=dev),
                    RT.standing_command(LOOP_BATCH - half, device=dev))
    roll = RT.make_rollout(LOOP_PERIODS, CFG)
    torch.cuda.synchronize()
    FR.launches = 0
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = FR.launches
    h = diags['height'].cpu().numpy()
    vx = diags['vx'].cpu().numpy()
    fallen = int(diags['fallen'].sum())
    quarantined = int(diags['quarantined'].sum())
    res = dict(
        phase='loop', batch=LOOP_BATCH, periods=LOOP_PERIODS,
        launches=loop_launches, seconds=loop_s,
        sim_s_per_wall_s=LOOP_PERIODS * 5 * CFG.plant.dt / loop_s,
        fallen_lane_periods=fallen, quarantined_lane_periods=quarantined,
        walk_min_height=float(h[:half].min()),
        walk_vx_last50=float(vx[:half, -50:].mean()),
        walk_x_final=float(plant.position[:half, 0].mean()),
        stand_height_last50=[float(h[half:, -50:].min()),
                             float(h[half:, -50:].max())],
        stand_vx_final=float(plant.v_world[half:, 0].abs().max()),
        card=card)
    emit(res)
    if loop_launches != LOOP_PERIODS:
        raise RuntimeError(f'closed loop launched the kernel {loop_launches} '
                           f'times, expected {LOOP_PERIODS}')
    if fallen or quarantined:
        raise RuntimeError('closed loop: lanes fell or were quarantined')
    # the bands of tests/test_closedloop.py
    if not (res['stand_height_last50'][0] > 0.45
            and res['stand_height_last50'][1] < 0.58
            and res['stand_vx_final'] < 0.05):
        raise RuntimeError('closed loop: standing lanes out of band')
    if not (res['walk_min_height'] > 0.4 and res['walk_vx_last50'] > 0.25
            and res['walk_x_final'] > 0.15):
        raise RuntimeError('closed loop: walking lanes out of band')

    emit({'kernels': [dict(
        name='fused_riccati', route='cuda',
        source='hector_torch/csrc/fused_riccati.cu',
        replaces='hector/qp/pallas_riccati.py:63',
        launches=main_launches, max_abs_err=max_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by='operations' if ops_ms >= bytes_ms else 'bytes',
        library_ms=None)]})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
