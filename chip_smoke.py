"""Drive the PyTorch port (hector_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  build       compile hector_torch/csrc/fused_riccati_warp.cu and chol.cu
              for sm_90a (one nvcc each, both started together) and report
              each kernel's registers, spills, shared memory and (Riccati
              kernels) resident warps an SM; neither instantiation of the
              Riccati kernel may use local memory, and the one without
              polish must keep to 128 registers and 16 warps an SM;
  kernel      the Riccati kernel without polish (the fused interior point,
              one warp a scenario) against its plain PyTorch version on the
              same QPs
              (closed-loop walking/standing states from a numpy seed, a
              ragged batch and the full 32,768-lane batch), max |du| <= 2e-4 N
              on every lane: both stopped after the same iterations where the
              freeze test (mu < 10 eps) flips on rounding, see hold_to_plain;
              the share of lanes frozen at each iteration;
  kernel_time the kernel and its plain version at 32,768 lanes, beside
              the bound;
  check       one planning step on the card against the same step on the CPU
              (the plain solver) on 256 closed-loop lanes;
  main        runtime.plan_step_fn at 32,768 lanes, 16 chained steps as
              bench.py chains them, counting kernel launches;
  loop        runtime.make_rollout for 200 MPC periods (1 s) at 1,024 lanes,
              half walking at 0.5 m/s, half standing: no fall, no quarantine,
              height in the band tests/test_closedloop.py asserts;
  chol        the Cholesky factor and solve kernels against their plain
              versions on the KKT matrices the dense interior point meets on
              closed-loop states (at its start and at iteration 5), at 4,096
              lanes and a ragged 4,099 (the solve also lane by lane against
              its plain version), with one bad matrix and one NaN QP
              that must stay alone, and timed at 4,096 beside the plain
              versions and torch.linalg.cholesky / torch.cholesky_solve;
  dense       plan_step_fn with backend='dense_auto' at 4,096 lanes, 8
              chained steps: 15 factor and 29 solve launches a step, forces
              against the 'pallas_interpret' run and the fused Riccati run
              on the same states;
  dense_loop  make_rollout with backend='dense_auto', 40 periods at 256
              lanes: no fall, no quarantine;
  polish      the kernel with polish (polish_rounds=8) against its plain
              version at 4,096 and 4,099 lanes and on the main path's
              32,768 QPs, and with the polish forced to reject (the
              interior point without freeze) at 2e-4 N on every lane; timed
              at 32,768 lanes beside the kernel without polish, and
              plan_step_fn with the polish on at 32,768 lanes, 4 chained
              steps (the kernel with polish only);
then the kernels line, the card's name and power limit, and the result
line.  Any failure raises, so the exit code is not 0 and no result line is
printed.  Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

KERNEL_TOL = 2e-4     # N, the bar tests/test_pallas_riccati.py holds the TPU kernel body to
# The freeze test mu < 10 eps is a threshold on a float32 sum: a lane whose
# mu lands within rounding of it may freeze one iteration earlier in one
# version than in the other (1 lane of 32,768 on closed-loop QPs), and one
# more interior-point step moves u
# by up to ~5e-3 N.  Such a lane is held to the plain version stopped after
# the same iterations, and its mu at the flip must sit within this share of
# the floor on both sides; at most FLIP_SHARE_MAX of the lanes may flip.
FLIP_MU_REL = 1e-4
FLIP_SHARE_MAX = 1e-3
# The same QPs stopped after n = 1..13 iterations, on lanes still running in
# both: the fixed point forgives a wrong Newton direction (a kernel with
# slightly wrong pivot reciprocals can still meet KERNEL_TOL at the end while
# its first iterates are far off), so the iterates are held too; an early
# iterate is one float32 Newton step from a cold start, hence 1e-3.
ITERATE_TOL = 1e-3
STEP_TOL = 1e-2       # N, card vs CPU planning step (f32 IP accuracy floor, tests/test_riccati.py)
MAIN_BATCH = 32768    # bench.py:54
MAIN_CHAIN = 16
LOOP_BATCH = 1024
LOOP_PERIODS = 200
FP32_PEAK = 67e12     # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12

DENSE_BATCH = 4096    # the batch at which the dense path is stated (README)
DENSE_CHAIN = 8
DENSE_LOOP_BATCH = 256
DENSE_LOOP_PERIODS = 40
RAGGED_BATCH = 4099
CHOL_FACTOR_TOL = 1e-4    # max |L_k - L_p| over max |L_p|, lower triangle
CHOL_SOLVE_TOL = 1e-3     # |L L^T x - rhs|_inf over |rhs|_inf, batch and worst lane
# |x_k - x_p|_inf over |x_p|_inf, every lane.  The kernel contracts a
# multiply and a subtract into one FMA, the plain version rounds twice; on the
# first KKT matrices (D = 0) the two agree to 3e-6 of a lane's |x|.  By
# iteration 5 the barrier weights have spread the matrices' spectra and the
# right-hand side is a small residual, and the same two roundings differ by
# up to 1.9e-4 on the worst of 4,096 lanes (H100, float32), less than either
# is from the float64 solve with the same L (2.4e-4 to 4.7e-4; both are
# printed): hence the looser bar there.
CHOL_SOLVE_VS_PLAIN_TOL = {'start': 1e-4, 'iteration 5': 1e-3}
DENSE_VS_INTERPRET_TOL = 2e-2   # N, tests/test_qp.py:131 (TPU kernels vs XLA)
DENSE_VS_RICCATI_TOL = 5e-2     # N, two different float32 interior points
POLISH_ROUNDS = 8         # what the JAX tests run (tests/test_pallas_riccati.py)
POLISH_CHAIN = 4
POLISH_SAME_SET = 0.99    # share of lanes on which kernel and plain agree to accept
POLISH_ACCEPTED_TOL = 2e-4    # N, lanes both accept
POLISH_ANY_TOL = 1e-2     # N, every lane (a flipped lane keeps the IP iterate)
# the design point of the kernel without polish: at most 128 registers a
# thread, 16 warps an SM
IP_MAX_REGISTERS = 128
IP_WARPS_PER_SM = 16


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

    def run():
        for _ in range(reps):
            fn()

    return cuda_timed(run)[0] / reps


def cuda_timed(fn):
    """fn() once between two CUDA events, synchronised before and after:
    (milliseconds, what fn returned)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: (ms, 'bytes' or 'operations')."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_PEAK * 1e3
    return ((ops_ms, 'operations') if ops_ms >= bytes_ms
            else (bytes_ms, 'bytes')) + (ops_ms, bytes_ms)


def with_solver(cfg, **kw):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **kw))


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


def scenario_problem(batch, seed, device, build):
    """The QP one planning step builds from scenarios(), through ``build``
    (mpc.build_parts or mpc.build_dense): the same preamble as
    runtime.controller_tick up to the QP."""
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
    _, problem = build(planner, est, q_data, p_foot_w, v_des, cmd.yaw_rate,
                       cmd.roll, cmd.pitch, gait, CFG)
    return problem


def scenario_parts(batch, seed, device):
    from hector_torch import mpc as M
    return scenario_problem(batch, seed, device, M.build_parts)


def to_cpu(tree):
    return type(tree)(*[to_cpu(x) if isinstance(x, tuple) else x.cpu()
                        for x in tree])


def chain(plan, carry, plant, cmd, n, wrenches=None):
    """n planning steps, each state depending on the last QP solution, as
    bench.py chains them."""
    wrench = motor = None
    for _ in range(n):
        carry, wrench, motor = plan(carry, plant, cmd)
        plant = plant._replace(
            position=plant.position + 1e-9 * wrench[:, 0, :3])
        if wrenches is not None:
            wrenches.append(wrench)
    return carry, plant, wrench, motor


KERNEL_NAMES = (('fused_riccati_warp_kernelILb0E', 'fused_riccati'),
                ('fused_riccati_warp_kernelILb1E', 'fused_riccati_polish'),
                ('chol_factor_kernel', 'chol_factor'),
                ('chol_solve_kernel', 'chol_solve'))


def parse_ptxas(text):
    """Registers, stack frame, spill bytes and shared memory of each kernel
    from nvcc -Xptxas -v, keyed by the kernel's name in this script."""
    out = {}
    cur = None
    for line in text.splitlines():
        if 'Compiling entry function' in line:
            cur = next((name for key, name in KERNEL_NAMES if key in line),
                       None)
            if cur is not None:
                out[cur] = {}
        elif cur is None:
            continue
        elif 'spill stores' in line and 'stack_frame_bytes' not in out[cur]:
            fields = [f.split()[0] for f in line.strip().split(',')]
            out[cur].update(stack_frame_bytes=int(fields[0]),
                            spill_store_bytes=int(fields[1]),
                            spill_load_bytes=int(fields[2]))
        elif 'Used ' in line and 'registers' not in out[cur]:
            out[cur]['registers'] = int(line.split('Used ')[1].split()[0])
            smem = [f for f in line.split(',') if f.strip().endswith('smem')]
            out[cur]['smem_bytes'] = (int(smem[0].split()[0]) if smem
                                      else 0)
    return out


def all_finite(**named):
    for name, x in named.items():
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'{name} not finite')


def freeze_iterations(solve, parts, scfg, q_diag, r_diag):
    """The solutions after n = 0..scfg.iterations interior-point iterations,
    and per lane the first iteration that skipped it (its u after n + 1
    iterations is its u after n bit for bit), or scfg.iterations if none."""
    sols = [solve(parts, dataclasses.replace(scfg, iterations=n), q_diag,
                  r_diag) for n in range(scfg.iterations + 1)]
    frozen = torch.full((parts.x0.shape[0],), scfg.iterations,
                        dtype=torch.long, device=parts.x0.device)
    for n in range(scfg.iterations - 1, -1, -1):
        frozen = torch.where((sols[n + 1].u == sols[n].u).all(1),
                             torch.full_like(frozen, n), frozen)
    return sols, frozen


def hold_to_plain(FR, parts, scfg, q_diag, r_diag):
    """The warp kernel against the plain version on the same QPs.  Lanes
    that freeze at the same iteration in both must agree to KERNEL_TOL.  A
    lane that freezes at iteration n in one and later in the other must
    have mu within FLIP_MU_REL of the floor at n in both (the test flipped
    on rounding), and agree to KERNEL_TOL with both stopped after n
    iterations.  The iterates after n = 1..iterations-1 iterations, on
    lanes neither version has frozen by then, must agree to ITERATE_TOL.
    Raises on a fault; returns the phase's record and the kernel's freeze
    iteration of each lane."""
    sols_k, fz_k = freeze_iterations(FR.solve_parts_cuda, parts, scfg,
                                     q_diag, r_diag)
    sols_p, fz_p = freeze_iterations(FR.solve_parts_plain, parts, scfg,
                                     q_diag, r_diag)
    torch.cuda.synchronize()
    sol_k, sol_p = sols_k[-1], sols_p[-1]
    batch = parts.x0.shape[0]
    stats = torch.stack([sol_k.mu, sol_k.r_dual, sol_k.r_prim])
    if not bool(torch.isfinite(sol_k.u).all() and torch.isfinite(stats).all()):
        raise RuntimeError(f'kernel output not finite at batch {batch}')
    du = (sol_k.u - sol_p.u).abs().amax(1)
    same = fz_k == fz_p
    err = float(du[same].max()) if bool(same.any()) else 0.0
    floor = 10.0 * torch.finfo(torch.float32).eps
    flips = []
    for lane in torch.nonzero(~same).flatten().tolist():
        n = int(min(fz_k[lane], fz_p[lane]))
        mus = (float(sols_k[n].mu[lane]), float(sols_p[n].mu[lane]))
        d_n = float((sols_k[n].u[lane] - sols_p[n].u[lane]).abs().max())
        flips.append(dict(lane=lane, iteration=n, mu_kernel=mus[0],
                          mu_plain=mus[1], max_abs_du_stopped=d_n,
                          max_abs_du_run_on=float(du[lane])))
        if not max(abs(m - floor) for m in mus) <= FLIP_MU_REL * floor:
            raise RuntimeError(f'lane {lane} freezes at {int(fz_k[lane])} '
                               f'in the kernel, {int(fz_p[lane])} in the '
                               f'plain version, mu {mus} not at the floor')
        err = max(err, d_n)
    # every earlier iterate, on the lanes neither version has frozen yet
    running = torch.minimum(fz_k, fz_p)
    by_iter = []
    for n in range(1, scfg.iterations):
        live = running >= n
        by_iter.append(float((sols_k[n].u[live] - sols_p[n].u[live]).abs()
                             .max()) if bool(live.any()) else 0.0)
    rec = dict(phase='kernel', batch=batch, max_abs_du=err,
               max_abs_du_by_iteration=by_iter,
               max_abs_du_without_flips=float(du[same].max())
               if bool(same.any()) else 0.0,
               max_abs_du_run_on=float(du.max()), flipped_lanes=flips,
               frozen_share_by_iteration=dict(
                   kernel=[float((fz_k <= n).float().mean())
                           for n in range(scfg.iterations)],
                   plain=[float((fz_p <= n).float().mean())
                          for n in range(scfg.iterations)]),
               max_mu=float(sol_k.mu.max()),
               max_r_prim=float(sol_k.r_prim.max()),
               u_scale=float(sol_p.u.abs().max()))
    emit(rec)
    if not math.isfinite(err) or err > KERNEL_TOL:
        raise RuntimeError(f'kernel vs plain max |du| {err} N > '
                           f'{KERNEL_TOL} N at batch {batch}')
    if not max(by_iter, default=0.0) <= ITERATE_TOL:
        raise RuntimeError(f'kernel vs plain iterates differ by up to '
                           f'{max(by_iter)} N > {ITERATE_TOL} N at batch '
                           f'{batch}: {by_iter}')
    if len(flips) > FLIP_SHARE_MAX * batch:
        raise RuntimeError(f'{len(flips)} lanes freeze at another iteration '
                           f'than in the plain version at batch {batch}')
    return rec, fz_k


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import mpc as M
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.qp import chol as CH
    from hector_torch.qp import fused_riccati as FR
    from hector_torch.qp import pdip as PD

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    scfg = CFG.solver
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)

    # ---- build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(FR.build), pool.submit(CH.build)]:
            fut.result()
    build_s = time.perf_counter() - t0
    ptxas = {}
    nvcc_seconds = {}
    for info in (*FR.build_info.values(), CH.build_info):
        ptxas.update(parse_ptxas(info.get('ptxas', '')))
    for name, info in (*FR.build_info.items(), ('chol.cu', CH.build_info)):
        nvcc_seconds[name] = info.get('seconds')
    attrs = {'fused_riccati': FR.kernel_attributes('warp'),
             'fused_riccati_polish': FR.kernel_attributes('polish')}
    emit(dict(phase='build', seconds=build_s, card=card,
              nvcc_seconds=nvcc_seconds, ptxas=ptxas, attributes=attrs))
    for name, attr in attrs.items():
        rep = ptxas.get(name, {})
        if not (rep and rep['spill_store_bytes'] == 0
                and rep['spill_load_bytes'] == 0
                and rep['stack_frame_bytes'] == 0
                and attr['local_bytes'] == 0):
            raise RuntimeError(f'{name} uses local memory: {rep}, {attr}')
    ip_attr = attrs['fused_riccati']
    if not (ip_attr['registers'] <= IP_MAX_REGISTERS
            and ip_attr['warps_per_sm'] >= IP_WARPS_PER_SM):
        raise RuntimeError(f'the kernel without polish takes '
                           f'{ip_attr["registers"]} registers and '
                           f'{ip_attr["warps_per_sm"]} warps an SM, not '
                           f'<= {IP_MAX_REGISTERS} and {IP_WARPS_PER_SM}')

    # ---- the kernel without polish vs its plain version ----
    max_err = 0.0
    for batch, seed in ((4096, 1), (RAGGED_BATCH, 2), (MAIN_BATCH, 3)):
        parts = scenario_parts(batch, seed, dev)
        rec, frozen = hold_to_plain(FR, parts, scfg, q_diag, r_diag)
        max_err = max(max_err, rec['max_abs_du'])
    main_parts = parts                  # 32,768 lanes, reused by the polish

    # ---- the kernel without polish, timed ----
    def ip_run():
        return FR.solve_parts_cuda(main_parts, scfg, q_diag, r_diag)

    kernel_ms_turns = [cuda_ms(ip_run, 10) for _ in range(2)]
    kernel_ms = sum(kernel_ms_turns) / 2
    plain_ms = cuda_ms(
        lambda: FR.solve_parts_plain(main_parts, scfg, q_diag, r_diag), 2)
    # the work these QPs need: a lane that freezes at iteration f needs the
    # start and f iterations (the f-th's test before its solve is left out)
    counts = torch.bincount(frozen, minlength=scfg.iterations + 1).tolist()
    ops = {key: sum(c * FR.op_count(f)[key] for f, c in enumerate(counts))
           / MAIN_BATCH for key in ('flop', 'div', 'sqrt')}
    n_ops = ops['flop'] + ops['div'] + ops['sqrt']
    ip_bound_ms, ip_bound_by, ops_ms, bytes_ms = bound_ms(
        MAIN_BATCH * FR.bytes_per_scenario(), MAIN_BATCH * n_ops)
    all_ops = FR.op_count(scfg.iterations)
    emit(dict(phase='kernel_time', batch=MAIN_BATCH, ms=kernel_ms,
              ms_turns=kernel_ms_turns, plain_ms=plain_ms,
              bound_ms=ip_bound_ms, ops_ms=ops_ms, bytes_ms=bytes_ms,
              ops_per_scenario=ops,
              lanes_by_freeze_iteration=counts,
              bound_ms_all_iterations=bound_ms(
                  MAIN_BATCH * FR.bytes_per_scenario(),
                  MAIN_BATCH * sum(all_ops.values()))[0],
              bytes_per_scenario=FR.bytes_per_scenario(),
              share_of_bound=ip_bound_ms / kernel_ms, card=card))

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
    main_state = (carry, plant, cmd)    # reused by the polish path

    chain(plan, carry, plant, cmd, 2)   # warm-up, not counted
    FR.launches = FR.polish_launches = 0
    CH.factor_launches = CH.solve_launches = 0
    total_ms, (c, p, wrench, motor) = cuda_timed(
        lambda: chain(plan, carry, plant, cmd, MAIN_CHAIN))
    main_launches = FR.launches
    step_ms = total_ms / MAIN_CHAIN
    if main_launches != MAIN_CHAIN:
        raise RuntimeError(f'main path launched the warp kernel '
                           f'{main_launches} times, expected {MAIN_CHAIN}')
    if FR.polish_launches or CH.factor_launches or CH.solve_launches:
        raise RuntimeError('main path launched a kernel that is not its own')
    for name, x in (('wrench', wrench), ('tau', motor.tau),
                    ('f_ff', c.planner.f_ff), ('position', p.position)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'main path output {name} not finite')
    emit(dict(phase='main', batch=MAIN_BATCH, chain=MAIN_CHAIN,
              launches=main_launches, ms_per_step=step_ms,
              warp_kernel_share_of_step=kernel_ms / step_ms,
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

    # ---- Cholesky kernels vs plain versions on the path's KKT matrices ----
    dense_scfg = dataclasses.replace(scfg, backend='auto')
    n = 12 * CFG.mpc.horizon
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    factor_err = solve_err = 0.0
    for batch, seed in ((DENSE_BATCH, 5), (RAGGED_BATCH, 6)):
        qp = scenario_problem(batch, seed, dev, M.build_dense)
        # what the interior point hands the wrappers: the first factor call
        # has D = 0, the last one is iteration 5's
        seen_m, seen_rhs = [], []
        factor_fn, solve_fn = CH.cholesky_bnn, CH.cholesky_solve_bnn
        CH.cholesky_bnn = lambda m: (seen_m.append(m), factor_fn(m))[1]
        CH.cholesky_solve_bnn = lambda ell, rhs: (
            seen_rhs.append(rhs), solve_fn(ell, rhs))[1]
        try:
            PD.solve_batched(qp, dataclasses.replace(dense_scfg, iterations=6))
        finally:
            CH.cholesky_bnn, CH.cholesky_solve_bnn = factor_fn, solve_fn
        for where, m, rhs in (('start', seen_m[0], seen_rhs[0]),
                              ('iteration 5', seen_m[-1], seen_rhs[-1])):
            l_k = CH.cholesky_bnn(m)
            x_k = CH.cholesky_solve_bnn(l_k, rhs)
            l_p = CH.cholesky_nnb_plain(m.permute(1, 2, 0)).permute(2, 0, 1)
            x_p = CH.cholesky_solve_nnb_plain(l_k.permute(1, 2, 0),
                                              rhs.t()).t()
            # the public batch-minor functions are views of the same kernels
            m_nnb = m.permute(1, 2, 0).contiguous()
            l_nnb = CH.cholesky_nnb(m_nnb)
            x_nnb = CH.cholesky_solve_nnb(l_nnb, rhs.t().contiguous())
            torch.cuda.synchronize()
            all_finite(l_k=l_k, x_k=x_k, l_p=l_p)
            l_scale = float(l_p.abs().max())
            d_l = float(((l_k - l_p) * lower).abs().max())
            upper_nonzero = int((l_k * ~lower).count_nonzero())
            l64, x64, r64 = l_k.double(), x_k.double(), rhs.double()
            resid = (l64 @ (l64.transpose(1, 2) @ x64[..., None]))[..., 0] - r64
            resid_rel = float(resid.abs().max()) / float(r64.abs().max())
            lane_rel = float((resid.abs().amax(1)
                              / r64.abs().amax(1).clamp(min=1e-30)).max())
            d_x = float((x_k - x_p).abs().max())
            x_true = torch.cholesky_solve(r64[..., None], l64)[..., 0]

            def worst_lane(x, ref):
                return float(((x - ref).abs().amax(1)
                              / ref.abs().amax(1).clamp(min=1e-30)).max())

            d_x_lane = worst_lane(x_k, x_p)
            dx_tol = CHOL_SOLVE_VS_PLAIN_TOL[where]
            views_equal = bool(torch.equal(l_nnb.permute(2, 0, 1), l_k)
                               and torch.equal(x_nnb.t(), x_k))
            emit(dict(phase='chol', batch=batch, matrices=where,
                      max_abs_dl=d_l, l_scale=l_scale,
                      rel_dl=d_l / l_scale, upper_nonzero=upper_nonzero,
                      solve_residual_rel=resid_rel,
                      solve_residual_rel_worst_lane=lane_rel,
                      max_abs_dx_vs_plain=d_x,
                      rel_dx_vs_plain_worst_lane=d_x_lane,
                      rel_dx_vs_plain_tol=dx_tol,
                      rel_dx_vs_f64_worst_lane=dict(
                          kernel=worst_lane(x_k.double(), x_true),
                          plain=worst_lane(x_p.double(), x_true)),
                      x_scale=float(x_p.abs().max()),
                      nnb_views_equal=views_equal))
            if d_l > CHOL_FACTOR_TOL * l_scale:
                raise RuntimeError(f'factor kernel vs plain: {d_l} > '
                                   f'{CHOL_FACTOR_TOL} * {l_scale}')
            if upper_nonzero:
                raise RuntimeError('factor kernel left non-zeros above the '
                                   'diagonal')
            if not max(resid_rel, lane_rel) <= CHOL_SOLVE_TOL:
                raise RuntimeError(f'solve kernel residual {resid_rel} (worst '
                                   f'lane {lane_rel}) > {CHOL_SOLVE_TOL}')
            if not d_x_lane <= dx_tol:
                raise RuntimeError(f'solve kernel vs plain: {d_x_lane} of a '
                                   f'lane\'s |x| > {dx_tol}')
            if not views_equal:
                raise RuntimeError('the (n, n, B) views disagree with the '
                                   '(B, n, n) kernels')
            factor_err, solve_err = max(factor_err, d_l), max(solve_err, d_x)
            if batch == DENSE_BATCH:
                m_time, rhs_time, l_time = m, rhs, l_k
        # no pivot floor: a matrix that is not positive definite goes
        # non-finite alone, and a QP with a non-finite gradient is skipped by
        # the interior point; neither touches its neighbours
        bad = 3
        m_bad = m.clone()
        m_bad[bad, 5, 5] = -1.0
        l_bad = CH.cholesky_bnn(m_bad)
        others = torch.arange(batch, device=dev) != bad
        g_bad = qp.g_vec.clone()
        g_bad[bad, 3] = float('nan')
        sol_ok = PD.solve_batched(qp, dense_scfg)
        sol_bad = PD.solve_batched(qp._replace(g_vec=g_bad), dense_scfg)
        torch.cuda.synchronize()
        lane_alone = bool(not torch.isfinite(l_bad[bad]).all()
                          and torch.equal(l_bad[others], l_k[others]))
        qp_skipped = bool(not sol_bad.u[bad].any()
                          and torch.equal(sol_bad.u[others], sol_ok.u[others])
                          and torch.isfinite(sol_bad.u).all())
        emit(dict(phase='chol_bad_lane', batch=batch,
                  bad_matrix_stays_in_its_lane=lane_alone,
                  nan_qp_skipped_and_isolated=qp_skipped))
        if not (lane_alone and qp_skipped):
            raise RuntimeError('a bad lane leaked into its neighbours')
    m_nnb = m_time.permute(1, 2, 0).contiguous()
    l_nnb = l_time.permute(1, 2, 0).contiguous()
    rhs_nb = rhs_time.t().contiguous()
    factor_ms = cuda_ms(lambda: CH.cholesky_bnn(m_time), 20)
    solve_ms = cuda_ms(lambda: CH.cholesky_solve_bnn(l_time, rhs_time), 20)
    factor_nnb_ms = cuda_ms(lambda: CH.cholesky_nnb(m_nnb), 5)
    solve_nnb_ms = cuda_ms(lambda: CH.cholesky_solve_nnb(l_nnb, rhs_nb), 5)
    factor_plain_ms = cuda_ms(lambda: CH.cholesky_nnb_plain(m_nnb), 2)
    solve_plain_ms = cuda_ms(
        lambda: CH.cholesky_solve_nnb_plain(l_nnb, rhs_nb), 2)
    factor_lib_ms = cuda_ms(lambda: torch.linalg.cholesky(m_time), 10)
    rhs_col = rhs_time[..., None].contiguous()
    solve_lib_ms = cuda_ms(lambda: torch.cholesky_solve(rhs_col, l_time), 10)
    f_ops, s_ops = CH.factor_op_count(n), CH.solve_op_count(n)
    f_bound = bound_ms(DENSE_BATCH * CH.factor_bytes(n),
                       DENSE_BATCH * sum(f_ops.values()))
    s_bound = bound_ms(DENSE_BATCH * CH.solve_bytes(n),
                       DENSE_BATCH * sum(s_ops.values()))
    emit(dict(phase='chol_time', batch=DENSE_BATCH, n=n,
              factor=dict(ms=factor_ms, nnb_view_ms=factor_nnb_ms,
                          plain_ms=factor_plain_ms, library_ms=factor_lib_ms,
                          bound_ms=f_bound[0], bound_by=f_bound[1],
                          ops_ms=f_bound[2], bytes_ms=f_bound[3],
                          share_of_bound=f_bound[0] / factor_ms),
              solve=dict(ms=solve_ms, nnb_view_ms=solve_nnb_ms,
                         plain_ms=solve_plain_ms, library_ms=solve_lib_ms,
                         bound_ms=s_bound[0], bound_by=s_bound[1],
                         ops_ms=s_bound[2], bytes_ms=s_bound[3],
                         share_of_bound=s_bound[0] / solve_ms),
              card=card))
    del m_nnb, l_nnb, seen_m, seen_rhs, m_time, l_time, l64, x64, r64, resid
    del x_true
    del m_bad, l_bad, sol_ok, sol_bad

    # ---- dense path: chained planning steps through the two kernels ----
    carry, plant, cmd = scenarios(DENSE_BATCH, 7, dev)
    plan_dense = RT.plan_step_fn(with_solver(CFG, backend='dense_auto'))
    chain(plan_dense, carry, plant, cmd, 1)         # warm-up, not counted
    FR.launches = FR.polish_launches = 0
    CH.factor_launches = CH.solve_launches = 0
    w_dense = []
    total_ms, (c, p, wrench, motor) = cuda_timed(
        lambda: chain(plan_dense, carry, plant, cmd, DENSE_CHAIN, w_dense))
    dense_factor_launches = CH.factor_launches
    dense_solve_launches = CH.solve_launches
    dense_step_ms = total_ms / DENSE_CHAIN
    want = (DENSE_CHAIN * (scfg.iterations + 1),
            DENSE_CHAIN * (2 * scfg.iterations + 1))
    if ((dense_factor_launches, dense_solve_launches) != want
            or FR.launches or FR.polish_launches):
        raise RuntimeError(
            f'dense path launched factor/solve {dense_factor_launches}/'
            f'{dense_solve_launches} times (and the Riccati kernel '
            f'{FR.launches + FR.polish_launches} times), expected '
            f'{want[0]}/{want[1]} (and 0)')
    all_finite(dense_wrench=torch.stack(w_dense), dense_tau=motor.tau,
               dense_f_ff=c.planner.f_ff, dense_position=p.position)
    # the same states through the plain versions and through the fused
    # Riccati solver (no launches of the Cholesky kernels in either)
    w_interp, w_riccati = [], []
    chain(RT.plan_step_fn(with_solver(CFG, backend='pallas_interpret')),
          carry, plant, cmd, DENSE_CHAIN, w_interp)
    chain(plan, carry, plant, cmd, DENSE_CHAIN, w_riccati)
    torch.cuda.synchronize()
    if (CH.factor_launches, CH.solve_launches) != want:
        raise RuntimeError('the comparison runs launched Cholesky kernels')
    d_interp = float((torch.stack(w_dense) - torch.stack(w_interp)).abs().max())
    d_riccati = float((torch.stack(w_dense)
                       - torch.stack(w_riccati)).abs().max())
    kernels_ms = ((scfg.iterations + 1) * factor_ms
                  + (2 * scfg.iterations + 1) * solve_ms)
    emit(dict(phase='dense', batch=DENSE_BATCH, chain=DENSE_CHAIN,
              factor_launches=dense_factor_launches,
              solve_launches=dense_solve_launches,
              ms_per_step=dense_step_ms,
              solves_per_s=DENSE_BATCH / dense_step_ms * 1e3,
              kernels_ms_per_step=kernels_ms,
              kernels_share_of_step=kernels_ms / dense_step_ms,
              max_abs_vs_pallas_interpret=d_interp,
              max_abs_vs_fused_riccati=d_riccati,
              wrench_scale=float(torch.stack(w_dense).abs().max()),
              card=card))
    if not d_interp <= DENSE_VS_INTERPRET_TOL:
        raise RuntimeError(f'dense path vs pallas_interpret: {d_interp} N > '
                           f'{DENSE_VS_INTERPRET_TOL} N')
    if not d_riccati <= DENSE_VS_RICCATI_TOL:
        raise RuntimeError(f'dense path vs fused Riccati: {d_riccati} N > '
                           f'{DENSE_VS_RICCATI_TOL} N')

    # ---- dense closed loop ----
    half = DENSE_LOOP_BATCH // 2
    plant = srb.init_plant_state(DENSE_LOOP_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.concat(RT.walking_command(half, vx=0.5, device=dev),
                    RT.standing_command(DENSE_LOOP_BATCH - half, device=dev))
    roll = RT.make_rollout(DENSE_LOOP_PERIODS,
                           with_solver(CFG, backend='dense_auto'))
    torch.cuda.synchronize()
    CH.factor_launches = CH.solve_launches = 0
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd)
    torch.cuda.synchronize()
    dense_loop_s = time.perf_counter() - t0
    fallen = int(diags['fallen'].sum())
    quarantined = int(diags['quarantined'].sum())
    h = diags['height'].cpu().numpy()
    emit(dict(phase='dense_loop', batch=DENSE_LOOP_BATCH,
              periods=DENSE_LOOP_PERIODS,
              factor_launches=CH.factor_launches,
              solve_launches=CH.solve_launches, seconds=dense_loop_s,
              fallen_lane_periods=fallen,
              quarantined_lane_periods=quarantined,
              min_height=float(h.min()),
              max_qp_mu=float(diags['qp_mu'].max()),
              walk_x_final=float(plant.position[:half, 0].mean()),
              card=card))
    want = (DENSE_LOOP_PERIODS * (scfg.iterations + 1),
            DENSE_LOOP_PERIODS * (2 * scfg.iterations + 1))
    if (CH.factor_launches, CH.solve_launches) != want:
        raise RuntimeError(f'dense loop launched factor/solve '
                           f'{CH.factor_launches}/{CH.solve_launches} times, '
                           f'expected {want[0]}/{want[1]}')
    if fallen or quarantined:
        raise RuntimeError('dense loop: lanes fell or were quarantined')
    all_finite(dense_loop_height=diags['height'],
               dense_loop_position=plant.position)
    if not h.min() > 0.4:
        raise RuntimeError('dense loop: a lane collapsed')

    # ---- polish: the kernel with polish_rounds=8 vs its plain version ----
    pcfg = dataclasses.replace(scfg, polish_rounds=POLISH_ROUNDS)
    # with a negative tolerance no lane can accept the polish: what differs
    # from that run was accepted, and that run is the interior point without
    # freeze, which only the kernel with polish runs
    pcfg_off = dataclasses.replace(pcfg, polish_tol=-1.0)
    polish_err = 0.0
    # at 4,096 and ragged 4,099 lanes, and on the QPs of the main path
    for batch, parts in ((4096, scenario_parts(4096, 8, dev)),
                         (RAGGED_BATCH, scenario_parts(RAGGED_BATCH, 9, dev)),
                         (MAIN_BATCH, main_parts)):
        sol_k = FR.solve_parts_cuda(parts, pcfg, q_diag, r_diag)
        off_k = FR.solve_parts_cuda(parts, pcfg_off, q_diag, r_diag)
        sol_p = FR.solve_parts_plain(parts, pcfg, q_diag, r_diag)
        off_p = FR.solve_parts_plain(parts, pcfg_off, q_diag, r_diag)
        torch.cuda.synchronize()
        all_finite(polish_u=sol_k.u, polish_stats=torch.stack(
            [sol_k.mu, sol_k.r_dual, sol_k.r_prim]), rejected_u=off_k.u)
        acc_k = (sol_k.u != off_k.u).any(1)
        acc_p = (sol_p.u != off_p.u).any(1)
        both = acc_k & acc_p
        same_set = float((acc_k == acc_p).float().mean())
        du = (sol_k.u - sol_p.u).abs().amax(1)
        du_both = float(du[both].max()) if bool(both.any()) else 0.0
        du_any = float(du.max())
        du_off = float((off_k.u - off_p.u).abs().max())
        emit(dict(phase='polish', batch=batch,
                  accepted_share_kernel=float(acc_k.float().mean()),
                  accepted_share_plain=float(acc_p.float().mean()),
                  same_set_share=same_set,
                  max_abs_du_both_accept=du_both, max_abs_du_any=du_any,
                  max_r_prim=float(sol_k.r_prim.max()),
                  max_r_prim_accepted=float(sol_k.r_prim[acc_k].max())
                  if bool(acc_k.any()) else None,
                  max_abs_du_rejected=du_off))
        if same_set < POLISH_SAME_SET:
            raise RuntimeError(f'polish: kernel and plain accept the same '
                               f'lanes on {same_set} < {POLISH_SAME_SET}')
        if not du_both <= POLISH_ACCEPTED_TOL:
            raise RuntimeError(f'polish: {du_both} N > {POLISH_ACCEPTED_TOL} '
                               f'N on lanes both accept')
        if not du_any <= POLISH_ANY_TOL:
            raise RuntimeError(f'polish: {du_any} N > {POLISH_ANY_TOL} N')
        if not du_off <= KERNEL_TOL:
            raise RuntimeError(f'polish forced to reject: {du_off} N > '
                               f'{KERNEL_TOL} N')
        polish_err = max(polish_err, du_any)

    def polish_run():
        return FR.solve_parts_cuda(main_parts, pcfg, q_diag, r_diag)

    # in turns, on the same QPs: with polish, without, without, with
    turns = {'polish': [], 'ip': []}
    for name, fn, reps in (('polish', polish_run, 3), ('ip', ip_run, 10),
                           ('ip', ip_run, 10), ('polish', polish_run, 3)):
        turns[name].append(cuda_ms(fn, reps))
    polish_ms = sum(turns['polish']) / 2
    kernel_ms_again = sum(turns['ip']) / 2
    polish_plain_ms = cuda_ms(
        lambda: FR.solve_parts_plain(main_parts, pcfg, q_diag, r_diag), 1)
    pol_steps = pcfg.polish_rounds * pcfg.polish_iters
    pops = FR.op_count(scfg.iterations, pol_steps)
    pol_bound = bound_ms(MAIN_BATCH * FR.bytes_per_scenario(),
                         MAIN_BATCH * sum(pops.values()))
    emit(dict(phase='polish_time', batch=MAIN_BATCH, polish_steps=pol_steps,
              ms=polish_ms, ms_turns=turns['polish'],
              ms_without_polish=kernel_ms_again,
              ms_without_polish_turns=turns['ip'],
              ms_without_polish_first=kernel_ms,
              plain_ms=polish_plain_ms,
              bound_ms=pol_bound[0], bound_by=pol_bound[1],
              share_of_bound=pol_bound[0] / polish_ms,
              ops_per_scenario=pops,
              ptxas=ptxas.get('fused_riccati_polish', {}),
              attributes=attrs['fused_riccati_polish'],
              card=card))

    # ---- polish path: chained planning steps with the polish on ----
    carry, plant, cmd = main_state
    plan_polish = RT.plan_step_fn(with_solver(CFG,
                                              polish_rounds=POLISH_ROUNDS))
    chain(plan_polish, carry, plant, cmd, 1)        # warm-up, not counted
    FR.launches = FR.polish_launches = 0
    CH.factor_launches = CH.solve_launches = 0
    total_ms, (c, p, wrench, motor) = cuda_timed(
        lambda: chain(plan_polish, carry, plant, cmd, POLISH_CHAIN))
    polish_path_launches = FR.polish_launches
    polish_step_ms = total_ms / POLISH_CHAIN
    if (polish_path_launches != POLISH_CHAIN or FR.launches
            or CH.factor_launches or CH.solve_launches):
        raise RuntimeError(
            f'polish path launched the kernel with polish '
            f'{polish_path_launches} times, without {FR.launches} times and '
            f'the Cholesky kernels {CH.factor_launches}/{CH.solve_launches} '
            f'times, expected {POLISH_CHAIN}, 0 and 0/0')
    all_finite(polish_wrench=wrench, polish_tau=motor.tau,
               polish_f_ff=c.planner.f_ff)
    emit(dict(phase='polish_path', batch=MAIN_BATCH, chain=POLISH_CHAIN,
              launches=polish_path_launches, ms_per_step=polish_step_ms,
              card=card))

    emit({'kernels': [
        dict(name='fused_riccati', route='cuda',
             source='hector_torch/csrc/fused_riccati_warp.cu',
             replaces='hector/qp/pallas_riccati.py:63',
             launches=main_launches, max_abs_err=max_err, ms=kernel_ms,
             plain_ms=plain_ms, bound_ms=ip_bound_ms, bound_by=ip_bound_by,
             library_ms=None),
        dict(name='fused_riccati_polish', route='cuda',
             source='hector_torch/csrc/fused_riccati_warp.cu',
             replaces='hector/qp/pallas_riccati.py:542',
             launches=polish_path_launches, max_abs_err=polish_err,
             ms=polish_ms, plain_ms=polish_plain_ms, bound_ms=pol_bound[0],
             bound_by=pol_bound[1], library_ms=None),
        dict(name='chol_factor', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:48',
             launches=dense_factor_launches, max_abs_err=factor_err,
             ms=factor_ms, plain_ms=factor_plain_ms, bound_ms=f_bound[0],
             bound_by=f_bound[1], library_ms=factor_lib_ms),
        dict(name='chol_solve', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:77',
             launches=dense_solve_launches, max_abs_err=solve_err,
             ms=solve_ms, plain_ms=solve_plain_ms, bound_ms=s_bound[0],
             bound_by=s_bound[1], library_ms=solve_lib_ms)]})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
