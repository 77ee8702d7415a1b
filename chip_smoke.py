"""Drive the PyTorch port (hector_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  build       compile hector_torch/csrc/fused_riccati_warp.cu, chol.cu and
              srb_plant.cu for sm_90a (one nvcc each, all started together)
              and report each kernel's registers, spills, shared memory and
              resident warps an SM; no instantiation of the Riccati kernel
              and no Cholesky kernel may use local memory, the plant and
              leg-data kernels may not spill (their precise trigonometry
              keeps a stack frame for the slow argument reduction), the
              Riccati kernel
              without polish must keep to 128 registers and 16 warps an SM,
              the cluster factor to 128 registers, and the streaming solve
              must hold 8 blocks an SM at n = 288;
  plant       the tier-1 plant kernel (srb_plant_step_kernel, one thread a
              lane) against srb.step_plain on 16,384 seeded lanes with the
              bars of tests/test_torch_plant_kernel.py, under the default
              and another configuration (float64, float32, non-finite
              masks); the kernel alone at 1,024 and 16,384 lanes from a
              CUDA graph of 100 launches, beside the plain step and the
              bytes a lane reads and writes at 3.35 TB/s;
  legs        the tick's leg-data kernel (tick_legs_kernel, one thread a
              lane, kinematics.leg_data on CUDA tensors) against the three
              lines of controller_tick it replaces, with the bars of
              tests/test_torch_legs_kernel.py at 1,024 and 32,768 seeded
              lanes under the default and another configuration (float64,
              float32, non-finite masks); the kernel alone at those sizes
              from a CUDA graph of 100 launches, beside the plain lines
              replayed and the bytes a lane reads and writes at 3.35 TB/s;
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
              under backend='riccati_pallas' (the plain solver; the CPU's
              'auto' is the Mehrotra stage solver) on 256 closed-loop lanes,
              and the same step on the card under
              backend='riccati_pallas_interpret' (the plain solver on CUDA
              tensors: no solver kernel launched);
  riccati     plan_step_fn with backend='riccati' (the Mehrotra stage solver,
              batched PyTorch ops) at 4,096 closed-loop lanes: one eager
              step, and one with polish_rounds=8, under
              set_sync_debug_mode('error') (the solve waits on nothing); 8
              chained steps through bench.make_chain (captured, replayed)
              timed beside the eager chain and bit for bit it, with the
              capture's seconds and nodes: no kernel of the port launched
              but the leg data, once a step;
              the first step within 1e-2 N of the CPU's 'riccati' step,
              which the CPU's default 'auto' step equals bit for bit; every
              step within 5e-2 N of the fused kernel's;
  main        runtime.plan_step_fn at 32,768 lanes, 16 chained steps as
              bench.py chains them, counting kernel launches: the chained
              step captured as a CUDA graph and replayed (bench.make_chain,
              the path a user runs), timed beside the eager chain, bit for
              bit;
  bench       `python -m hector_torch bench` in this process at its full
              shape (32,768 lanes, 128 chained steps, one chain not timed
              and 3 timed): exactly (1 + 3) x 128 = 512 launches of the
              kernel without polish and 512 of the leg data and nothing
              else; the record with
              bench.py's keys in its order, a finite positive value; that
              value within 0.5-2x of `main`'s solves/s, the same step timed
              by another clock, so a step that waits on the card or launches
              twice falls outside (BENCH_VS_MAIN);
  stage_entry fused_riccati.solve_batched on the StageQPData of the main
              path's states (32,768 lanes): one launch of each kernel; the
              kernel held freeze-aware to solve_parts on the compact build
              and to its plain version on the same slices, the polish to
              solve_parts;
  loop        runtime.make_rollout for 200 MPC periods (1 s) at 1,024 lanes
              (its period captured as a CUDA graph and replayed, as in
              every closed loop below on the fused solver),
              half walking at 0.5 m/s, half standing: no fall, no quarantine,
              height in the band tests/test_closedloop.py asserts;
  robust      make_rollout with pushes and a command/mode schedule for 300
              periods (1.5 s) at 1,024 lanes in five groups (robust_inputs):
              each group's checks from tests/test_robustness.py and
              tests/test_fsm_transitions.py, 300 launches of the kernel
              without polish, 1,500 of the plant kernel, 1,500 of the leg
              data and nothing else;
              the same rollout for 10
              periods at 16 lanes on the card and on the CPU under
              'riccati_pallas': every period's wrench within 1e-2 N, the
              final plant state within ROBUST_SHORT_STATE_TOL;
  estimators  make_rollout driven by the noisy estimators 'kf' (Mahony +
              contact-aided KF) and 'filtered', EST_PERIODS periods (1 s) at
              EST_BATCH lanes walking at 0.5 m/s, each lane's noise keyed
              fold_in(PRNGKey(7), lane): the checks of
              tests/test_estimation.py:149-178, one launch of the kernel
              without polish a period, one of the plant kernel and one of
              the leg data a tick and nothing else, the tier-1 loop's
              speed; one est_update('kf') tick timed, and run under
              torch.cuda.set_sync_debug_mode('error'); the same rollout for
              10 periods at 16 lanes on the card and on the CPU under
              'riccati_pallas' with the same keys (estimators_card_vs_cpu);
  whole_body  make_rollout_whole_body (the articulated tier-2 plant) for
              WB_PERIODS periods (0.5 s) at WB_BATCH lanes, half standing
              and half walking at 0.3 m/s under the cheater, then every lane
              walking at 0.5 m/s under 'kf': the checks of
              tests/test_whole_body.py:79-96,154-181 that hold at that
              horizon, one launch a period, the loop's speed; one WB.step
              timed and run without a synchronisation; the 'kf' rollout for
              10 periods at 16 lanes on the card and on the CPU
              (whole_body_card_vs_cpu);
  graph       each path the port captures (hector_torch/graph.py) against
              its eager run on the card, the same inputs: the tier-1 loop,
              the robustness rollout, the 'kf' and 'filtered' loops and the
              tier-2 loop (GRAPH_PERIODS periods at 1,024 lanes) and the
              chained planning step (32,768 lanes, 16 steps; 4 with
              polish_rounds=8), and the dense interior point: its period
              under 'dense_auto' and 'xla' (GRAPH_PERIODS periods at 1,024
              lanes) and 'pallas_interpret' (2 periods at 16 lanes), its
              chained step (4,096 lanes, 8 steps), its horizon-24 batch
              solve through pdip.make_solver (1,024 lanes) alone and inside
              a step that is itself captured, and the stage solver
              'riccati': its period (GRAPH_PERIODS periods at 1,024 lanes),
              its chained step (4,096 lanes, 8 steps) and its horizon-24
              batch solve through riccati.make_solver (1,024 lanes; its
              largest force gaps to the float64 stage solver and to the
              dense solve on the same scenarios recorded, graph_gaps): bit
              for bit, the same launches replayed and eager (one of <false>
              a step, <true> with the polish; 15 factors and 29 solves a
              dense step or period, at horizon 24 all on the cluster factor
              and the streaming solve; none under 'riccati'; the leg data
              once a tick, the plant kernel once a tier-1 tick), one
              capture,
              the replays run under
              set_sync_debug_mode('error'), both timed, the capture's
              seconds, its graph's nodes, the peak device memory, and
              whether what the Cholesky wrappers saw starts on 16 bytes
              (the kernels' float4 test) in the capture and eager; then
              torch.profiler traces (hector_torch.io.profiling.trace) of
              5 replayed tier-1 periods, of the dense and the stage
              solver's chained steps (8 replayed steps each) and of the
              replayed dense horizon-24 solve (graph_trace): the top device
              ops and the card's idle share;
  chol        the Cholesky factor and solve kernels against their plain
              versions on the KKT matrices the dense interior point meets on
              closed-loop states (at its start and at iteration 5), at 4,096
              lanes and a ragged 4,099, lane by lane; the register-tile
              factor and solve against the shared-memory ones bit for bit,
              and the cluster factor (launched at n = 120) against the
              register-tile one; with one bad matrix and one NaN QP that
              must stay alone;
  chol_spd    the factor on seeded random SPD batches at n = 117 (a ragged
              tile grid), 240, and on the cluster kernel's side of the route
              249, 288, 300 (a ragged tile grid) and 339 (the ceiling), lane
              by lane, bit for bit the shared-triangle kernel, the route n
              says (register tiles up to 248, the cluster factor above); the
              solve on the same factors with junk above their diagonals bit
              for bit the shared-memory solve (on ±0, subnormal and huge
              right-hand sides too), the route n says (register tiles up to
              248, the streaming solve above), the streaming solve launched
              below its route bit for bit the tile solve, and lane by lane
              within 1e-4 of a lane's |x| from the plain version;
  chol_time   the factor kernels in turns (register tiles, shared memory,
              shared memory, register tiles) and the solve kernels with
              torch.cholesky_solve likewise (tiles, shared memory, library,
              library, shared memory, tiles) at 4,096 lanes, beside the
              plain versions and torch.linalg.cholesky;
  dense       plan_step_fn with backend='dense_auto' at 4,096 lanes, 8
              chained steps through bench.make_chain (captured, replayed)
              timed beside the eager chain and bit for bit it, with the
              capture's seconds, nodes and peak memory: 15 factor and 29
              solve launches a step in both, forces against the
              'pallas_interpret' run and the fused Riccati run on the same
              states;
  dense_loop  make_rollout with backend='dense_auto', 40 periods at 1,024
              lanes, one captured period replayed a period: 15 factor and
              29 solve launches a period, no fall, no quarantine;
  dense_long  the batch solve at horizon 24 (n = 288) at 1,024 lanes
              through pdip.make_solver (captured, replayed) and mpc.solve
              with backend='dense_auto' (eager), 3 of each in turns (the
              first of each counted, the medians reported), bit for bit:
              15 launches of the cluster factor (none of the
              shared-triangle one), 29 of the streaming solve (none of the
              shared-memory one) in both, the capture's seconds, nodes
              and peak memory; the
              forces no further from a float64 solve of the same QPs than
              the 'pallas_interpret' run's plus 2e-2 N (at this n the two
              float32 runs differ by ~0.1 N, while the factor keeps to 1e-4
              of a lane's max |L|); factor and solve lane by lane against
              their plain versions on the path's KKT matrices, the cluster
              factor bit for bit the shared-triangle one, the streaming
              solve bit for bit the shared-memory one (and on ±0, subnormal
              and huge right-hand sides); the cluster factor, the
              shared-triangle factor and torch.linalg.cholesky timed in
              turns on iteration 5's matrices, and the streaming solve, the
              shared-memory solve and torch.cholesky_solve likewise;
  polish      the kernel with polish (polish_rounds=8) against its plain
              version at 4,096 and 4,099 lanes and on the main path's
              32,768 QPs, and with the polish forced to reject (the
              interior point without freeze) at 2e-4 N on every lane; timed
              at 32,768 lanes beside the kernel without polish, its counts
              of polish steps over those solves every lane's and at least
              polish_iters - 1 of each round's re-solved, and
              plan_step_fn with the polish on at 32,768 lanes, 4 chained
              steps (the kernel with polish only);
  cli         the entry-point layer (hector_torch.cli, parallel, io):
              `batch` at 1,024 lanes for 1 s in this process (the sharded
              rollout on the one-card mesh: 200 launches of the kernel
              without polish, 1,000 of the plant kernel, 1,000 of the leg
              data and nothing else,
              the metrics finite, the
              mean height in the band of tests/test_parallel.py, the JSONL
              line equal to the printed record, a checkpoint), the same
              command at 16 lanes on the card and on --device cpu
              (cli_card_vs_cpu), the checkpoint restored on the card bit for
              bit and 10 periods resumed from a mid-run checkpoint bit for
              bit those run straight on (cli_checkpoint), four
              ScenarioStream batches at 1,024 lanes equal to
              generate_host's rows with next() run under
              set_sync_debug_mode('error'), one period timed with and
              without the next batch in flight (cli_stream), the float64
              oracle (native/qp_oracle.cpp) against both Riccati kernels on
              32 closed-loop lanes: without polish within 0.05 N, with it
              within 1e-3 N on the lanes that accept (cli_oracle), and
              `python -m hector_torch run --seconds 0.5` as a process
              (cli_module);
  multihost   parallel.multihost over NCCL: a one-process group (file://
              rendezvous, world size 1, rank 0), make_batch at 1,024 lanes
              over its mesh and a 20-period sharded rollout, against the
              same run without a group: the group on NCCL and the mesh the
              current card, 20 launches of the kernel without polish, 100
              of the plant kernel, 100 of the leg data and nothing else,
              both tensors all_reduce
              sees on that card (the
              rank's own, not another rank's), the metrics and the final
              plant state bit for bit (a one-rank reduction is exact);
then the kernels line, the card's name and power limit, and the result
line.  Any failure raises, so the exit code is not 0 and no result line is
printed.  Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
DENSE_LOOP_BATCH = 1024
DENSE_LOOP_PERIODS = 40
RAGGED_BATCH = 4099
# max |L_k - L_p| over max |L_p|, lower triangle, on every lane
CHOL_FACTOR_TOL = 1e-4
# a ragged tile grid; h = 20; above the tile kernel's 248, the cluster
# factor: a ragged edge of one row, h = 24, a ragged tile grid, the ceiling
SPD_SIZES = (117, 240, 249, 288, 300, 339)
TILE_MAX_N = 248          # the register-tile kernels' cut (chol.cu)
SPD_BATCH = 1024
LONG_HORIZON = 24         # n = 288: the cluster factor, the streaming solve
LONG_BATCH = 1024
LONG_SOLVES = 3           # timed solves; the median is reported, the first counted
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
# The same at the long horizon (n = 288): there the two roundings
# differ by up to 1.3e-4 of a lane's |x| already on the first KKT matrices
# (the shared-memory solve at n = 288, 1,024 lanes, H100), so both sets are
# held to the iteration-5 bar.
CHOL_SOLVE_VS_PLAIN_TOL_LONG = 1e-3
# The same on chol_spd's seeded SPD matrices (n = 117 ... 339): 1.4e-6 to
# 1.6e-6 of a lane's |x| measured on an H100, so the bar of the first KKT
# matrices
CHOL_SOLVE_VS_PLAIN_TOL_SPD = CHOL_SOLVE_VS_PLAIN_TOL['start']
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
# the cluster factor's design point: one 8 x 8 tile (64 registers) a thread
# under a cap of 128, no spill
CLUSTER_MAX_REGISTERS = 128
# the streaming solve's design point: at n = 288, 8 blocks an SM, so that
# 1,024 matrices run in one wave on 132 SMs
STREAM_BLOCKS_PER_SM = 8
# the Mehrotra stage solver ('riccati') on the card: closed-loop lanes,
# chained steps
RICCATI_BATCH = 4096
RICCATI_CHAIN = 8
# 'riccati' (Mehrotra) against the fused kernel (fixed sigma) on the same
# states: two different float32 interior points, which meet at their own
# float32 floors, as the dense one and the fused one do
# (DENSE_VS_RICCATI_TOL)
RICCATI_VS_FUSED_TOL = DENSE_VS_RICCATI_TOL
# the robustness rollout: five groups of lanes (robust_inputs), 300 MPC
# periods (1.5 s), so that a push over periods 40-49 has 250 periods to
# settle (tests/test_robustness.py gives it 290)
ROBUST_BATCH = LOOP_BATCH
ROBUST_PERIODS = 300
ROBUST_EVENTS = dict(push=(40, 50), passive=60, walk_again=72,
                     switches=(100, 200))
# the same rollout, short, card against CPU
ROBUST_SHORT_BATCH = 16
ROBUST_SHORT_PERIODS = 10
ROBUST_SHORT_EVENTS = dict(push=(2, 6), passive=3, walk_again=6,
                           switches=(4, 7))
# Card against CPU on that short rollout, both float32 and the same
# algorithm (the kernel and its plain version): the wrench of every period
# within STEP_TOL, the final plant state within these (m, m/s, rad, rad/s).
# On the CPU the same rollout in float32 is 4.3e-7 m, 1.0e-5 m/s, 9.4e-7
# rad and 3.6e-5 rad/s (qd) from float64 and its wrench 5.2e-3 N; the bars
# are 3-200 times those.
ROBUST_SHORT_STATE_TOL = {'*': 1e-4, 'qd': 1e-3}
# the noisy estimators on the tier-1 loop: every lane walking at 0.5 m/s,
# its sensor noise keyed fold_in(PRNGKey(7), lane) as
# tests/test_estimation.py keys its lanes
EST_BATCH = LOOP_BATCH
EST_PERIODS = 200
# the KF's position error is checked at the test's own horizon, 150 periods:
# x is its unobservable gauge mode and drifts (a float32 CPU rehearsal at 32
# lanes: at most 0.059 m after 150 periods, 0.074 m after 200; bar 0.08)
EST_CHECK_PERIODS = 150
EST_SHORT_BATCH = 16
EST_SHORT_PERIODS = 10
# the tier-2 plant: half the lanes standing and half walking at 0.3 m/s under
# the cheater, then every lane walking at 0.5 m/s under 'kf' (keys
# fold_in(PRNGKey(5), lane)); 100 periods (0.5 s)
WB_BATCH = LOOP_BATCH
WB_PERIODS = 100
WB_SHORT_BATCH = 16
WB_SHORT_PERIODS = 10
# tests/test_whole_body.py's progress bars pro rata to WB_PERIODS: x > 0.15
# m after 300 periods at 0.3 m/s, x > 0.8 m after 600 periods at 0.5 m/s
# under 'kf'.  A float32 CPU rehearsal with the plain solver reached 0.083
# and 0.154 m (8 and 4 lanes)
WB_WALK_X_MIN = 0.15 * WB_PERIODS / 300
WB_KF_X_MIN = 0.8 * WB_PERIODS / 600
WB_VY_SHARE = 0.99
# Card against CPU on the short rollouts, both float32 with the same noise
# keys: the bars of the robust phase.  With the noise off, the same short
# rollouts in float32 on the CPU are within 4.2e-3 N (wrench), 1.8e-7 m,
# 1.1e-6 m/s, 6.3e-6 rad/s (omega), 3.7e-5 rad/s (qd), 1.5e-6 (KF state) of
# float64 (tier 2; tier 1 'kf' 1.1e-4 N and 1.3e-5 rad/s qd), every contact
# flag equal
# the CLI (python -m hector_torch): `batch` at CLI_BATCH lanes for 1 s (200
# periods, one <false> launch each); its mean height in the band of
# tests/test_parallel.py:18-28
CLI_BATCH = LOOP_BATCH
CLI_SECONDS = 1.0
CLI_HEIGHT_BAND = (0.4, 0.6)
# `batch` at 16 lanes for 10 periods on the card and on --device cpu, with
# the bars tests/test_torch_cli.py holds the port's CPU CLI to against JAX's
# (mean height 1e-5 m, qp_mu_max 1 %, fallen counts equal).  'auto' is the
# fused kernel on the card and the Mehrotra stage solver on the CPU, as in
# the JAX package; a CPU rehearsal of the two solvers at this size gave
# equal mean heights and mu 0.7 % apart
CLI_SHORT_BATCH = 16
CLI_SHORT_SECONDS = 0.05
CLI_HEIGHT_TOL = 1e-5
CLI_MU_RTOL = 1e-2
# checkpoint resume: periods before and after the mid-run checkpoint
RESUME_PERIODS = 10
# the host pipeline: batches drawn from ScenarioStream, and the one-period
# rollouts timed with and without the next batch in flight (in turns)
STREAM_BATCH = 1024
STREAM_STEPS = 4
STREAM_TIMED = 4
# the float64 oracle (native/qp_oracle.cpp) holds the card's kernels on
# ORACLE_LANES closed-loop lanes: <false> within the float32 bar of
# tests/test_qp.py:107-117 on every lane, <true> within the bar of
# tests/test_qpoases_parity.py:146 on the lanes that accept the polish.  A
# CPU rehearsal with the plain versions on these lanes: 0.0116 N and
# 3.8e-5 N (every lane accepted)
ORACLE_LANES = 32
ORACLE_TOL = 0.05
ORACLE_POLISH_TOL = 1e-3
# `python -m hector_torch bench` (hector_torch/bench.py at its full shape):
# the record's keys in bench.py's order (bench.py:104-109), and its solves/s
# against the same run's `main`: the same step at the same batch, timed by
# the host clock over 128 steps a chain where `main` takes CUDA events over
# 16, so a factor 2 either way takes a step that waits on the card or
# launches twice
BENCH_KEYS = ['metric', 'value', 'unit', 'vs_baseline']
BENCH_VS_MAIN = (0.5, 2.0)
# multihost over NCCL: a one-process group (file:// rendezvous), the global
# batch and a sharded rollout, held bit for bit to the run without a group
MULTIHOST_BATCH = 1024
MULTIHOST_PERIODS = 20
# the keys `python -m hector run` prints (hector/cli.py:66-70)
GRAPH_PERIODS = 20     # each captured loop against its eager run (graph)
GRAPH_ROBUST_EVENTS = ROBUST_SHORT_EVENTS
GRAPH_TRACE_PERIODS = 5
GRAPH_SMALL_BATCH = 16   # the dense period under the plain versions (graph)
GRAPH_SMALL_PERIODS = 2
GRAPH_TOP_OPS = 12
RUN_KEYS = ['mean_height', 'min_height', 'fallen_frac', 'qp_mu_max',
            'qp_r_dual_max', 'x_traveled']


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


def scenario_problem(batch, seed, device, build, cfg=None):
    """The QP one planning step builds from scenarios() (state_problem)."""
    return state_problem(*scenarios(batch, seed, device), build, cfg)


def state_problem(carry, plant, cmd, build, cfg=None):
    """The QP one planning step builds from this state, through ``build``
    (mpc.build_parts, mpc.build_stage or mpc.build_dense): the same
    preamble as runtime.controller_tick up to the QP.  Under ``cfg``
    (default: the default config); a horizon other than the gait's 10
    segments takes the gait table on periodically."""
    from hector_torch import control as C, gait as G, mpc as M
    from hector_torch.config import DEFAULT_CONFIG, JOINT_OFFSETS
    from hector_torch.kinematics import foot_position
    from hector_torch.runtime import N_SEGMENTS

    CFG = cfg or DEFAULT_CONFIG
    device = plant.position.device
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
    gait = gait[:, torch.arange(CFG.mpc.horizon, device=device) % N_SEGMENTS]
    _, problem = build(planner, est, q_data, p_foot_w, v_des, cmd.yaw_rate,
                       cmd.roll, cmd.pitch, gait, CFG)
    return problem


def scenario_parts(batch, seed, device):
    from hector_torch import mpc as M
    return scenario_problem(batch, seed, device, M.build_parts)


def kkt_matrices(qp, scfg):
    """The KKT matrices and first right-hand sides the dense interior point
    hands the factor and solve wrappers over ``scfg.iterations`` iterations
    (the first factor call has D = 0)."""
    from hector_torch.qp import chol as CH
    from hector_torch.qp import pdip as PD
    seen_m, seen_rhs = [], []
    factor_fn, solve_fn = CH.cholesky_bnn, CH.cholesky_solve_bnn
    CH.cholesky_bnn = lambda m: (seen_m.append(m), factor_fn(m))[1]
    CH.cholesky_solve_bnn = lambda ell, rhs: (
        seen_rhs.append(rhs), solve_fn(ell, rhs))[1]
    try:
        PD.solve_batched(qp, scfg)
    finally:
        CH.cholesky_bnn, CH.cholesky_solve_bnn = factor_fn, solve_fn
    return seen_m, seen_rhs


def factor_vs_plain(l_k, m):
    """The factor held to its plain version: (max |dL| over the lower
    triangles, max |L_p|, the worst lane's max |dL| over its max |L_p|)."""
    from hector_torch.qp import chol as CH
    n = m.shape[1]
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=m.device))
    l_p = CH.cholesky_nnb_plain(m.permute(1, 2, 0)).permute(2, 0, 1)
    all_finite(l_k=l_k, l_p=l_p)
    d = ((l_k - l_p) * lower).abs().amax((1, 2))
    scale = l_p.abs().amax((1, 2))
    return (float(d.max()), float(scale.max()),
            float((d / scale.clamp(min=1e-30)).max()))


def launch_counts():
    """Every kernel wrapper's launch count that is not 0, by counter name
    (the registry cuda.counts)."""
    from hector_torch import cuda
    return {name: n for name, n in cuda.counts.read().items() if n}


def reset_launch_counts():
    from hector_torch import cuda
    cuda.counts.reset()


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
                ('srb_plant_step_kernelIfE', 'srb_plant'),
                ('srb_plant_step_kernelIdE', 'srb_plant_f64'),
                ('tick_legs_kernelIfE', 'tick_legs'),
                ('tick_legs_kernelIdE', 'tick_legs_f64'),
                ('fused_riccati_warp_kernelILb1E', 'fused_riccati_polish'),
                ('chol_factor_kernel', 'chol_factor'),
                ('chol_factor_smem_kernel', 'chol_factor_shared'),
                ('chol_factor_cluster_kernel', 'chol_factor_cluster'),
                ('chol_solve_kernel', 'chol_solve'),
                ('chol_solve_smem_kernel', 'chol_solve_shared'),
                ('chol_solve_stream_kernel', 'chol_solve_stream'))


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


def bit_equal(a, b):
    """The same float32 bits (so +0 is not -0)."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def edge_rhs(rhs):
    """rhs with lanes of +0, -0, subnormal and huge entries: the register-tile
    and streaming solves' fast divides take the first and fall back to IEEE
    divides on the others."""
    zero = torch.zeros_like(rhs[:8])
    return torch.cat([zero, -zero, rhs[16:24] * 1e-40, rhs[24:32] * 1e25,
                      rhs[32:]])


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


def hold_to_plain(FR, parts, scfg, q_diag, r_diag, phase='kernel'):
    """The warp kernel against the plain version on the same QPs
    (hold_freeze_aware)."""
    return hold_freeze_aware((FR.solve_parts_cuda, parts, q_diag, r_diag),
                             (FR.solve_parts_plain, parts, q_diag, r_diag),
                             scfg, phase)


def hold_freeze_aware(side_k, side_p, scfg, phase):
    """Two fixed-sigma solves, each (solve, parts, q_diag, r_diag): the
    first on the card (the kernel), the second its reference (the plain
    version, or the kernel on another build of the same QPs).  Lanes
    that freeze at the same iteration in both must agree to KERNEL_TOL.  A
    lane that freezes at iteration n in one and later in the other must
    have mu within FLIP_MU_REL of the floor at n in both (the test flipped
    on rounding), and agree to KERNEL_TOL with both stopped after n
    iterations.  The iterates after n = 1..iterations-1 iterations, on
    lanes neither side has frozen by then, must agree to ITERATE_TOL.
    Raises on a fault; returns the phase's record and the first side's
    freeze iteration of each lane."""
    solve_k, parts, q_k, r_k = side_k
    sols_k, fz_k = freeze_iterations(solve_k, parts, scfg, q_k, r_k)
    solve_p, parts_p, q_p, r_p = side_p
    sols_p, fz_p = freeze_iterations(solve_p, parts_p, scfg, q_p, r_p)
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
    rec = dict(phase=phase, batch=batch, max_abs_du=err,
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
        raise RuntimeError(f'{phase}: kernel vs reference max |du| {err} N '
                           f'> {KERNEL_TOL} N at batch {batch}')
    if not max(by_iter, default=0.0) <= ITERATE_TOL:
        raise RuntimeError(f'{phase}: kernel vs reference iterates differ by '
                           f'up to {max(by_iter)} N > {ITERATE_TOL} N at '
                           f'batch {batch}: {by_iter}')
    if len(flips) > FLIP_SHARE_MAX * batch:
        raise RuntimeError(f'{phase}: {len(flips)} lanes freeze at another '
                           f'iteration than in the reference at batch '
                           f'{batch}')
    return rec, fz_k


def hold_polish(side_k, side_p, pcfg, phase):
    """Two polish solves, each (solve, parts, q_diag, r_diag), the first on
    the card: run as configured and with the polish forced to reject
    (polish_tol = -1, the interior point without freeze, which only the
    kernel with polish runs).  What differs from the rejected run was
    accepted.  At least POLISH_SAME_SET of the lanes must accept alike,
    lanes both accept agree to POLISH_ACCEPTED_TOL, every lane to
    POLISH_ANY_TOL, the rejected runs to KERNEL_TOL.  Raises on a fault;
    returns the largest |du| over all lanes."""
    pcfg_off = dataclasses.replace(pcfg, polish_tol=-1.0)
    (solve_k, parts_k, q_k, r_k), (solve_p, parts_p, q_p, r_p) = side_k, side_p
    sol_k = solve_k(parts_k, pcfg, q_k, r_k)
    off_k = solve_k(parts_k, pcfg_off, q_k, r_k)
    sol_p = solve_p(parts_p, pcfg, q_p, r_p)
    off_p = solve_p(parts_p, pcfg_off, q_p, r_p)
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
    emit(dict(phase=phase, batch=parts_k.x0.shape[0],
              accepted_share_kernel=float(acc_k.float().mean()),
              accepted_share_plain=float(acc_p.float().mean()),
              same_set_share=same_set,
              max_abs_du_both_accept=du_both, max_abs_du_any=du_any,
              max_r_prim=float(sol_k.r_prim.max()),
              max_r_prim_accepted=float(sol_k.r_prim[acc_k].max())
              if bool(acc_k.any()) else None,
              max_abs_du_rejected=du_off))
    if same_set < POLISH_SAME_SET:
        raise RuntimeError(f'{phase}: the two sides accept the same lanes on '
                           f'{same_set} < {POLISH_SAME_SET}')
    if not du_both <= POLISH_ACCEPTED_TOL:
        raise RuntimeError(f'{phase}: {du_both} N > {POLISH_ACCEPTED_TOL} N '
                           f'on lanes both accept')
    if not du_any <= POLISH_ANY_TOL:
        raise RuntimeError(f'{phase}: {du_any} N > {POLISH_ANY_TOL} N')
    if not du_off <= KERNEL_TOL:
        raise RuntimeError(f'{phase}, polish forced to reject: {du_off} N > '
                           f'{KERNEL_TOL} N')
    return du_any


def robust_inputs(batch, periods, events, device):
    """The robustness rollout's inputs, five groups of lanes (from
    tests/test_robustness.py and tests/test_fsm_transitions.py):
      0 (a) walking at 0.3 m/s, a 40 N lateral push over events['push'];
      1 (b) standing, the same push;
      2 (c) walking at 0.3 m/s, passive at events['passive'] and left so;
      3 (d) walking at 0.3 m/s, passive at events['passive'], walking
            again at events['walk_again'];
      4 (e) walking at 0.5 m/s, the standing gait between the two
            events['switches'], then walking again.
    Returns (group of each lane, cmd, disturbance (B, periods, 6),
    schedule (cmd_t, mode_cmd_t))."""
    from hector_torch import control as C
    from hector_torch import runtime as RT
    g = batch // 5
    groups = torch.repeat_interleave(
        torch.arange(5), torch.tensor([g, g, g, g, batch - 4 * g])).to(device)
    options = [RT.walking_command(batch, vx=0.3, device=device),
               RT.standing_command(batch, device=device),
               RT.walking_command(batch, vx=0.5, device=device)]
    t = torch.arange(periods, device=device)
    which = torch.zeros((batch, periods), dtype=torch.long, device=device)
    which[groups == 1] = 1
    lo, hi = events['switches']
    which[groups == 4] = torch.where((t >= lo) & (t < hi), 1, 2)
    lanes = torch.arange(batch, device=device)[:, None]
    cmd_t = RT.ScenarioCommand(*[torch.stack(f)[which, lanes]
                                 for f in zip(*options)])
    mode_t = torch.full((batch, periods), RT.MODE_CMD_NONE,
                        dtype=torch.int32, device=device)
    mode_t[(groups == 2) | (groups == 3), events['passive']] = C.MODE_PASSIVE
    mode_t[groups == 3, events['walk_again']] = C.MODE_WALKING
    dist = torch.zeros((batch, periods, 6), device=device)
    push = (groups == 0) | (groups == 1)
    dist[push, events['push'][0]:events['push'][1], 1] = 40.0
    cmd = RT.ScenarioCommand(*[f[:, 0] for f in cmd_t])
    return groups, cmd, dist, (cmd_t, mode_t)


def robust_checks(groups, diags, plant, events):
    """Each group of robust_inputs held to its test's checks: (per group the
    measured values, the names of the groups that failed)."""
    h = diags['height'].cpu()
    mode = diags['mode'].cpu()
    fallen = diags['fallen'].cpu()
    pos = plant.position.cpu()
    groups = groups.cpu()
    p, w = events['passive'], events['walk_again']
    res, ok = {}, {}
    a, b, c, d, e = [groups == k for k in range(5)]
    res['a_push_walking'] = dict(
        fallen_lanes=int(fallen[a].any(1).sum()),
        min_height=float(h[a].min()),
        max_abs_y_final=float(pos[a, 1].abs().max()))
    ok['a_push_walking'] = (res['a_push_walking']['fallen_lanes'] == 0
                            and res['a_push_walking']['min_height'] > 0.4
                            and res['a_push_walking']['max_abs_y_final'] < 0.2)
    res['b_push_standing'] = dict(
        min_abs_y_final=float(pos[b, 1].abs().min()))
    ok['b_push_standing'] = res['b_push_standing']['min_abs_y_final'] > 0.2
    res['c_passive'] = dict(
        passive_from_command=bool((mode[c, p:] == 0).all()),
        max_x_final=float(pos[c, 0].max()),
        min_x_final_of_a=float(pos[a, 0].min()))
    ok['c_passive'] = (res['c_passive']['passive_from_command']
                       and res['c_passive']['max_x_final']
                       < res['c_passive']['min_x_final_of_a'])
    hd = h[d]
    res['d_passive_then_walking'] = dict(
        walking_before=bool((mode[d, :p] == 1).all()),
        passive_between=bool((mode[d, p:w] == 0).all()),
        walking_after=bool((mode[d, w + 3:] == 1).all()),
        max_drop_height=float((hd[:, w - 1] - hd[:, p - 1]).max()),
        fallen_last_20=int(fallen[d, -20:].sum()),
        min_height_last_20=float(hd[:, -20:].min()),
        min_rise_after=float((hd[:, -1] - hd[:, w + 8]).min()))
    r = res['d_passive_then_walking']
    ok['d_passive_then_walking'] = (
        r['walking_before'] and r['passive_between'] and r['walking_after']
        and r['max_drop_height'] <= -0.012 and r['fallen_last_20'] == 0
        and r['min_height_last_20'] > 0.42 and r['min_rise_after'] > 0.0)
    res['e_gait_schedule'] = dict(fallen_lanes=int(fallen[e].any(1).sum()),
                                  min_height=float(h[e].min()))
    ok['e_gait_schedule'] = res['e_gait_schedule']['fallen_lanes'] == 0
    return res, [k for k, v in ok.items() if not v]


def riccati_phase(card, dev):
    """The Mehrotra stage solver ('riccati') on the card: RICCATI_CHAIN
    chained planning steps at RICCATI_BATCH closed-loop lanes through
    bench.make_chain (captured, replayed), timed beside the eager chain and
    bit for bit it; one eager step, and one with polish_rounds=8, under
    set_sync_debug_mode('error') (the solve waits on nothing); no kernel of
    the port launched but the tick's leg data, one a step; the first step within STEP_TOL of the CPU's
    'riccati' step, which the CPU's default 'auto' step equals bit for bit;
    every step within RICCATI_VS_FUSED_TOL of the fused kernel's."""
    from hector_torch import bench
    from hector_torch import runtime as RT
    from hector_torch.config import DEFAULT_CONFIG as CFG

    plan = RT.plan_step_fn(CFG)
    carry, plant, cmd = scenarios(RICCATI_BATCH, 11, dev)
    cfg_r = with_solver(CFG, backend='riccati')
    plan_r = RT.plan_step_fn(cfg_r)
    chain(plan_r, carry, plant, cmd, 1)             # warm-up, not counted
    # the proof that the solve waits on nothing: eager steps that would
    # raise at any wait, with and without the polish
    without_sync("'riccati' planning step", lambda: plan_r(carry, plant, cmd))
    plan_rp = RT.plan_step_fn(with_solver(cfg_r, polish_rounds=POLISH_ROUNDS))
    plan_rp(carry, plant, cmd)                      # warm-up
    without_sync("'riccati' planning step (polish)",
                 lambda: plan_rp(carry, plant, cmd))
    chained = bench.make_chain(plan_r, RICCATI_CHAIN).steps
    chained((carry, plant), cmd)        # warm-up and capture, not counted
    reset_launch_counts()
    total_ms, ((c, p), _) = cuda_timed(lambda: chained((carry, plant), cmd))
    g_counts = launch_counts()
    reset_launch_counts()
    w_r = []
    eager_ms, (c_e, p_e, _, _) = cuda_timed(
        lambda: chain(plan_r, carry, plant, cmd, RICCATI_CHAIN, w_r))
    r_counts = launch_counts()
    riccati_step_ms = total_ms / RICCATI_CHAIN
    eager_step_ms = eager_ms / RICCATI_CHAIN
    captured_is_eager = tree_equal((c, p), (c_e, p_e))
    all_finite(riccati_wrench=torch.stack(w_r), riccati_f_ff=c.planner.f_ff)
    # the same chained states through the fused kernel on the card, and the
    # first step on the CPU under 'riccati' and under the default 'auto'
    w_f = []
    chain(plan, carry, plant, cmd, RICCATI_CHAIN, w_f)
    cpu_state = (to_cpu(carry), to_cpu(plant), to_cpu(cmd))
    _, w_r_cpu, m_r_cpu = plan_r(*cpu_state)
    _, w_auto_cpu, m_auto_cpu = plan(*cpu_state)
    _, _, m_r0 = plan_r(carry, plant, cmd)
    torch.cuda.synchronize()
    d_cpu = max(float((w_r[0].cpu() - w_r_cpu).abs().max()),
                float((m_r0.tau.cpu() - m_r_cpu.tau).abs().max()))
    d_fused = float((torch.stack(w_r) - torch.stack(w_f)).abs().max())
    auto_is_riccati = bool(torch.equal(w_auto_cpu, w_r_cpu)
                           and torch.equal(m_auto_cpu.tau, m_r_cpu.tau))
    emit(dict(phase='riccati', batch=RICCATI_BATCH, chain=RICCATI_CHAIN,
              ms_per_step=riccati_step_ms, eager_ms_per_step=eager_step_ms,
              graph_over_eager=eager_step_ms / riccati_step_ms,
              solves_per_s=RICCATI_BATCH / riccati_step_ms * 1e3,
              capture_seconds=capture_seconds(chained),
              graph_nodes=graph_nodes(chained)[0],
              captured_bit_equal_eager=captured_is_eager,
              launches=r_counts, graph_launches=g_counts,
              max_abs_vs_cpu=d_cpu, max_abs_vs_fused_kernel=d_fused,
              cpu_auto_equals_riccati=auto_is_riccati,
              wrench_scale=float(w_r_cpu.abs().max()), card=card))
    want = {'legs_launches': RICCATI_CHAIN}
    if r_counts != want or g_counts != want:
        raise RuntimeError(f"'riccati' launched kernels of the port: "
                           f'{r_counts} eager, {g_counts} captured, '
                           f'expected {want}')
    if not captured_is_eager:
        raise RuntimeError("'riccati': the captured chain is not bit for bit "
                           'the eager chain')
    if len(chained.captures) != 1:
        raise RuntimeError(f"'riccati': {len(chained.captures)} captures of "
                           f'one signature')
    if not d_cpu <= STEP_TOL:
        raise RuntimeError(f"'riccati' on the card vs the CPU: {d_cpu} N > "
                           f'{STEP_TOL} N')
    if not d_fused <= RICCATI_VS_FUSED_TOL:
        raise RuntimeError(f"'riccati' vs the fused kernel on the card: "
                           f'{d_fused} N > {RICCATI_VS_FUSED_TOL} N')
    if not auto_is_riccati:
        raise RuntimeError("'auto' on the CPU is not the 'riccati' step")


def stage_entry_phase(main_state, card):
    """fused_riccati.solve_batched on the StageQPData of the main path's
    states: one <false> launch, one <true> launch with the polish; held
    freeze-aware to solve_parts on the compact build and to the plain
    version on the same slices, the polish to solve_parts.  Returns the
    largest |du| against the plain version."""
    from hector_torch import mpc as M
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.cuda import counts as LC      # the launch counts
    from hector_torch.qp import fused_riccati as FR

    scfg = CFG.solver
    pcfg = dataclasses.replace(scfg, polish_rounds=POLISH_ROUNDS)
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)
    sqp = state_problem(*main_state, M.build_stage)
    parts_main = state_problem(*main_state, M.build_parts)
    # the weights as solve_batched reads them from the float32 tensors
    q_t = tuple(sqp.q_diag[-1].tolist())
    r_t = tuple(sqp.r_diag[-1].tolist())
    LC.launches = LC.polish_launches = 0
    sol_e = FR.solve_batched(sqp, scfg)
    torch.cuda.synchronize()
    entry_launches = (LC.launches, LC.polish_launches)
    sol_ep = FR.solve_batched(sqp, pcfg)
    torch.cuda.synchronize()
    entry_polish_launches = (LC.launches, LC.polish_launches)
    all_finite(entry_u=sol_e.u, entry_polish_u=sol_ep.u)
    stage_slices = FR.stage_parts(sqp)
    # the entry is the kernel on the stage form's slices, which the
    # comparisons below hold
    entry_is_slices = bit_equal(
        sol_e.u, FR.solve_parts_cuda(stage_slices, scfg, q_t, r_t).u)
    emit(dict(phase='stage_entry', batch=MAIN_BATCH,
              launches=entry_launches[0],
              polish_launches=entry_polish_launches[1],
              entry_is_the_kernel_on_its_slices=entry_is_slices,
              scal_equal=bit_equal(stage_slices.scal, parts_main.scal),
              b69_equal=bit_equal(stage_slices.b69, parts_main.b69),
              weights_from_tensors=dict(q_diag=q_t, r_diag=r_t)))
    if entry_launches != (1, 0) or entry_polish_launches != (1, 1):
        raise RuntimeError(f'stage entry launched <false>/<true> '
                           f'{entry_launches} and then {entry_polish_launches}'
                           f' times, expected (1, 0) and (1, 1)')
    if not entry_is_slices:
        raise RuntimeError('stage entry differs from the kernel on the '
                           'stage form\'s slices')
    # freeze-aware against solve_parts on the compact build, and against
    # the plain version on the same slices
    hold_freeze_aware((FR.solve_parts_cuda, stage_slices, q_t, r_t),
                      (FR.solve_parts_cuda, parts_main, q_diag, r_diag),
                      scfg, 'stage_entry_vs_solve_parts')
    stage_rec, _ = hold_to_plain(FR, stage_slices, scfg, q_t, r_t,
                                 'stage_entry_vs_plain')
    hold_polish((FR.solve_parts_cuda, stage_slices, q_t, r_t),
                (FR.solve_parts_cuda, parts_main, q_diag, r_diag), pcfg,
                'stage_entry_polish_vs_solve_parts')
    return stage_rec['max_abs_du']


def robust_phase(card, dev):
    """make_rollout with pushes and a command/mode schedule on the card
    (robust_inputs, robust_checks), ROBUST_PERIODS at ROBUST_BATCH lanes
    under the default config: ROBUST_PERIODS launches of <false>, five of
    the plant kernel and five of the leg data a period and nothing else; then the same rollout,
    short, on the card and on the CPU
    under 'riccati_pallas'."""
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG

    groups, cmd, dist, sched = robust_inputs(ROBUST_BATCH, ROBUST_PERIODS,
                                             ROBUST_EVENTS, dev)
    plant = srb.init_plant_state(ROBUST_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    roll = RT.make_rollout(ROBUST_PERIODS, CFG, with_disturbance=True,
                           with_schedule=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd, dist, sched)
    torch.cuda.synchronize()
    robust_s = time.perf_counter() - t0
    robust_launches = launch_counts()
    all_finite(robust_position=plant.position, robust_height=diags['height'])
    res, failed = robust_checks(groups, diags, plant, ROBUST_EVENTS)
    emit(dict(phase='robust', batch=ROBUST_BATCH, periods=ROBUST_PERIODS,
              launches=robust_launches, seconds=robust_s,
              sim_s_per_wall_s=ROBUST_PERIODS * 5 * CFG.plant.dt / robust_s,
              capture_seconds=capture_seconds(roll.graphed),
              groups=res, failed=failed, card=card))
    if robust_launches != {'launches': ROBUST_PERIODS,
                           'plant_launches': 5 * ROBUST_PERIODS,
                           'legs_launches': 5 * ROBUST_PERIODS}:
        raise RuntimeError(f'robust rollout launched {robust_launches}, '
                           f'expected {ROBUST_PERIODS} <false>, '
                           f'{5 * ROBUST_PERIODS} plant steps and leg data '
                           f'and nothing else')
    if failed:
        raise RuntimeError(f'robust rollout: groups {failed} failed their '
                           f'checks')
    # the same rollout, short, on the card and on the CPU (the fused solver
    # on both: the kernel and its plain version)
    short_cfg = with_solver(CFG, backend='riccati_pallas')
    short = {}
    for where in ('card', 'cpu'):
        d = dev if where == 'card' else torch.device('cpu')
        _, cmd_s, dist_s, sched_s = robust_inputs(
            ROBUST_SHORT_BATCH, ROBUST_SHORT_PERIODS, ROBUST_SHORT_EVENTS, d)
        plant_s = srb.init_plant_state(ROBUST_SHORT_BATCH, CFG, device=d)
        roll_s = RT.make_rollout(ROBUST_SHORT_PERIODS, short_cfg,
                                 with_disturbance=True, with_schedule=True)
        _, p_s, d_s = roll_s(RT.init_controller_carry(plant_s, CFG),
                             plant_s, cmd_s, dist_s, sched_s)
        short[where] = (to_cpu(p_s), {k: v.cpu() for k, v in d_s.items()})
    (p_card, d_card), (p_cpu, d_cpu) = short['card'], short['cpu']
    d_wrench = float((d_card['wrench'] - d_cpu['wrench']).abs().max())
    d_state = {name: float((a.double() - b.double()).abs().max())
               for name, a, b in zip(p_card._fields, p_card, p_cpu)
               if a.dtype.is_floating_point}
    same_flags = bool(torch.equal(p_card.contact, p_cpu.contact)
                      and torch.equal(d_card['mode'], d_cpu['mode'])
                      and torch.equal(d_card['contact'], d_cpu['contact']))
    re_entered = bool(((d_cpu['mode'][:, ROBUST_SHORT_EVENTS['passive']]
                        == 0)
                       & (d_cpu['mode'][:, -1] == 1)).any())
    emit(dict(phase='robust_card_vs_cpu', batch=ROBUST_SHORT_BATCH,
              periods=ROBUST_SHORT_PERIODS, max_abs_wrench=d_wrench,
              max_abs_state=d_state, flags_equal=same_flags,
              a_lane_re_entered=re_entered,
              wrench_scale=float(d_cpu['wrench'].abs().max())))
    state_bad = {k: v for k, v in d_state.items()
                 if not v <= ROBUST_SHORT_STATE_TOL.get(
                     k, ROBUST_SHORT_STATE_TOL['*'])}
    if not (d_wrench <= STEP_TOL and not state_bad and same_flags
            and re_entered):
        raise RuntimeError(f'robust rollout, card vs CPU: wrench {d_wrench} '
                           f'N (bar {STEP_TOL}), state {state_bad}, flags '
                           f'equal {same_flags}, re-entered {re_entered}')


def estimator_checks(kind, diags, carry, plant):
    """The checks of tests/test_estimation.py:149-178 on a walk at 0.5 m/s
    driven by ``kind`` (carry and plant: the state after EST_CHECK_PERIODS
    periods): (measured values, failed check names)."""
    h = diags['height'].cpu()
    vx = diags['vx'].cpu()
    res = dict(fallen_lanes=int(diags['fallen'].any(1).sum()),
               min_vx_last50=float(vx[:, -50:].mean(1).min()),
               min_height_last50=float(h[:, -50:].min()))
    bars = dict(fallen_lanes=lambda v: v == 0,
                min_vx_last50=lambda v: v > 0.2,
                min_height_last50=lambda v: v > (0.38 if kind == 'kf'
                                                 else 0.4))
    if kind == 'kf':
        res['max_kf_position_error'] = float(
            (carry.est.kf.x[:, 0:3] - plant.position).abs().max())
        bars['max_kf_position_error'] = lambda v: v < 0.08
    return res, [k for k, ok in bars.items() if not ok(res[k])]


def card_vs_cpu(phase, make, periods, batch, keys_seed, make_plant,
                make_cmd, dev, **labels):
    """The same short rollout (``make(cfg)``) on the card and on the CPU,
    float32, the fused solver on both (the kernel and its plain version),
    the same per-lane noise keys: every period's wrench within STEP_TOL,
    the final plant state and the estimator's KF state and quaternion
    within ROBUST_SHORT_STATE_TOL, every mode, contact and fall flag equal.
    Emits the phase's line; raises when a bar is missed."""
    from hector_torch import prng
    from hector_torch.config import DEFAULT_CONFIG as CFG
    out = {}
    for where in ('card', 'cpu'):
        d = dev if where == 'card' else torch.device('cpu')
        plant = make_plant(batch, d)
        roll = make(with_solver(CFG, backend='riccati_pallas'))
        carry = roll.init(plant, prng.fold_in(prng.PRNGKey(keys_seed, d),
                                              torch.arange(batch, device=d)))
        c, p, diags = roll(carry, plant, make_cmd(batch, d))
        out[where] = (to_cpu(c), to_cpu(p),
                      {k: v.cpu() for k, v in diags.items()})
    (c_k, p_k, d_k), (c_c, p_c, d_c) = out['card'], out['cpu']
    d_w = float((d_k['wrench'] - d_c['wrench']).abs().max())
    d_state = {name: float((a.double() - b.double()).abs().max())
               for name, a, b in zip(p_k._fields, p_k, p_c)
               if a.dtype.is_floating_point}
    d_est = {'kf_x': float((c_k.est.kf.x - c_c.est.kf.x).abs().max()),
             'mahony_quat': float((c_k.est.mahony.quat
                                   - c_c.est.mahony.quat).abs().max())}
    flags = bool(torch.equal(d_k['mode'], d_c['mode'])
                 and torch.equal(d_k['contact'], d_c['contact'])
                 and torch.equal(d_k['fallen'], d_c['fallen'])
                 and all(torch.equal(a, b) for a, b in zip(p_k, p_c)
                         if a.dtype == torch.bool))
    emit(dict(phase=phase, **labels, batch=batch, periods=periods,
              max_abs_wrench=d_w, max_abs_state=d_state,
              max_abs_estimator=d_est, flags_equal=flags,
              wrench_scale=float(d_c['wrench'].abs().max())))
    bad = {k: v for k, v in {**d_state, **d_est}.items()
           if not v <= ROBUST_SHORT_STATE_TOL.get(
               k, ROBUST_SHORT_STATE_TOL['*'])}
    if not (d_w <= STEP_TOL and not bad and flags):
        raise RuntimeError(f'{phase} {labels}: wrench {d_w} N (bar '
                           f'{STEP_TOL}), out of bar {bad}, flags equal '
                           f'{flags}')


def timed_rollout(roll, carry, plant, cmd, periods, CFG):
    """One rollout on the card, host clock, synchronised: (carry, plant,
    diagnostics, seconds, simulated s per wall s, launches of <false>, the
    other counters that moved)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.pop('launches', 0)
    return (carry, plant, diags, sec,
            periods * CFG.mpc.mpc_cadence * CFG.plant.dt / sec,
            launches, counts)


PLANT_CHECK_BATCH = 16384   # lanes of the plant kernel's checks
PLANT_TIME_BATCHES = (1024, 16384)
PLANT_GRAPH_LAUNCHES = 100  # plant kernel launches in the timed graph


def plant_test_module():
    """tests/test_torch_plant_kernel.py (it imports no JAX): the seeded
    batches and the checks the plant phase holds the kernel to."""
    path = Path(__file__).resolve().parent / 'tests' / \
        'test_torch_plant_kernel.py'
    spec = importlib.util.spec_from_file_location('plant_kernel_tests', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def graph_ms(fn, launches, reps=5):
    """Device milliseconds a call of fn() takes, from a CUDA graph of
    ``launches`` calls replayed ``reps`` times: no host time between the
    calls, as inside a captured period."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()

    def replay():
        for _ in range(reps):
            g.replay()

    replay()
    return cuda_timed(replay)[0] / (reps * launches)


def plant_phase(card, dev, ptxas, attrs):
    """srb_plant_step_kernel against srb.step_plain on the card with the
    seeded batches and the bars of tests/test_torch_plant_kernel.py
    (float64 within 1e-12 of each output's size, times the stance IK's
    condition number on the joints of a stance leg; float32 at the 50th
    and 90th percentile and the widest lane no wider than twice the plain
    float32 step's gap to the plain float64 one; the non-finite masks
    exact), under the default and another configuration; then the kernel
    alone at 1,024 and 16,384 lanes from a CUDA graph, beside the plain
    step (from a graph and eager) and the bytes a lane reads and writes at
    the HBM rate.  Emits the record; returns the kernels line's entry."""
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.plant import srb
    T = plant_test_module()
    checks = {}
    for name, cfg, seed in (('default', CFG, 303),
                            ('other', T.OTHER_CFG, 404)):
        d = T.batch(PLANT_CHECK_BATCH, seed=seed, cfg=cfg)
        a64 = T.inputs(d, torch.float64, dev)
        got, ref = srb.step(*a64, cfg=cfg), srb.step_plain(*a64, cfg=cfg)
        a32 = T.inputs(d, torch.float32, dev)
        kern, plain = srb.step(*a32, cfg=cfg), srb.step_plain(*a32, cfg=cfg)
        try:
            for pair in ((got, ref), (kern, plain), (kern, ref)):
                T.nonfinite_masks_agree(*pair)
            masks = True
        except AssertionError:
            masks = False
        fin = T.finite_lanes(ref)
        checks[name] = dict(
            f64_excess=T.f64_excess(got, ref, a64, cfg),
            f32_kernel_gap=T.quantiles(T.lane_gaps(kern, ref)[fin]),
            f32_plain_gap=T.quantiles(T.lane_gaps(plain, ref)[fin]),
            nonfinite_masks_agree=masks, finite_lanes=int(fin.sum()))
    times = {}
    for n in PLANT_TIME_BATCHES:
        args = T.inputs(T.batch(n, seed=5, nonfinite=False), torch.float32,
                        dev)
        turns = [graph_ms(lambda: srb.step_cuda(*args), PLANT_GRAPH_LAUNCHES)
                 for _ in range(2)]
        ms = sum(turns) / 2
        bound = bound_ms(n * srb.bytes_per_lane(), 0)[0]
        times[n] = dict(ms=ms, ms_turns=turns,
                        plain_graph_ms=graph_ms(
                            lambda: srb.step_plain(*args), 5, 2),
                        plain_eager_ms=cuda_ms(
                            lambda: srb.step_plain(*args), 5),
                        bound_ms=bound, share_of_bound=bound / ms)
    emit(dict(phase='plant', checks=checks, times=times,
              bytes_per_lane=srb.bytes_per_lane(),
              ptxas={k: ptxas.get(k, {}) for k in attrs}, attributes=attrs,
              card=card))
    for name, c in checks.items():
        if not (c['nonfinite_masks_agree'] and c['f64_excess'] <= 1.0
                and all(k <= T.F32_FACTOR * p for k, p in
                        zip(c['f32_kernel_gap'], c['f32_plain_gap']))):
            raise RuntimeError(f'plant kernel ({name}) against its plain '
                               f'version: {c}')
    t = times[PLANT_TIME_BATCHES[0]]
    return dict(name='srb_plant', route='cuda',
                source='hector_torch/csrc/srb_plant.cu', replaces=None,
                launches=None,      # the loop phase's, set there
                max_abs_err=max(
                    c['f32_kernel_gap'][-1] for c in checks.values()),
                ms=t['ms'], plain_ms=t['plain_graph_ms'],
                bound_ms=t['bound_ms'], bound_by='bytes', library_ms=None)


LEGS_BATCHES = (1024, 32768)  # the loop's lanes and the plan cells'
LEGS_GRAPH_LAUNCHES = 100   # leg-data launches in the timed graph
# bytes a float32 lane of the leg data reads and writes, each once: the
# angles (10 numbers), J_force_moment (60), the feet (6) and q_data (10)
LEGS_BYTES_PER_LANE = 4 * (10 + 60 + 6 + 10)


def legs_phase(card, dev, ptxas, attrs):
    """tick_legs_kernel (kinematics.leg_data on CUDA tensors) against the
    three lines of controller_tick it replaces, with the seeded angles and
    the bars of tests/test_torch_legs_kernel.py (float64 within 1e-12 of
    each output's size; float32 at the 50th and 90th percentile and the
    widest lane no wider than twice the plain float32 path's gap to the
    plain float64 one; the non-finite masks exact), under the default and
    another configuration, at 1,024 and 32,768 lanes; then the kernel
    alone at those sizes from a CUDA graph, beside the plain lines replayed
    from a graph and the bytes a lane reads and writes at the HBM rate.
    Emits the record; returns the kernels line's entry."""
    from hector_torch import kinematics as K
    from hector_torch.config import DEFAULT_CONFIG as CFG
    L = importlib.import_module('tests.test_torch_legs_kernel')
    checks = {}
    for name, cfg in (('default', CFG), ('other', L.OTHER_CFG)):
        for n in LEGS_BATCHES:
            q64 = torch.tensor(L.angles(n, seed=n + 505), dtype=torch.float64,
                               device=dev)
            got, ref = K.leg_data(q64, cfg), L.plain(q64, cfg)
            q32 = q64.float()
            kern, plain = K.leg_data(q32, cfg), L.plain(q32, cfg)
            try:
                for pair in ((got, ref), (kern, plain), (kern, ref)):
                    L.nonfinite_masks_agree(*pair)
                masks = True
            except AssertionError:
                masks = False
            checks[f'{name}@{n}'] = dict(
                f64_excess=L.f64_excess(got, ref),
                f32_ratio_to_plain=L.f32_ratios(kern, plain, ref, q32),
                f32_kernel_gap=L.quantiles(L.lane_gaps(kern, ref)),
                nonfinite_masks_agree=masks)
    times = {}
    for n in LEGS_BATCHES:
        q = torch.tensor(L.angles(n, seed=5, nonfinite=False),
                         dtype=torch.float32, device=dev)
        turns = [graph_ms(lambda: K.leg_data_cuda(q, CFG),
                          LEGS_GRAPH_LAUNCHES) for _ in range(2)]
        ms = sum(turns) / 2
        bound = bound_ms(n * LEGS_BYTES_PER_LANE, 0)[0]
        times[n] = dict(ms=ms, ms_turns=turns,
                        plain_graph_ms=graph_ms(lambda: L.plain(q, CFG), 5,
                                                2),
                        bound_ms=bound, share_of_bound=bound / ms)
    emit(dict(phase='legs', checks=checks, times=times,
              bytes_per_lane=LEGS_BYTES_PER_LANE,
              ptxas={k: ptxas.get(k, {}) for k in attrs}, attributes=attrs,
              card=card))
    for name, c in checks.items():
        if not (c['nonfinite_masks_agree'] and c['f64_excess'] <= 1.0
                and all(r <= L.F32_FACTOR for r in c['f32_ratio_to_plain'])):
            raise RuntimeError(f'leg-data kernel ({name}) against its plain '
                               f'version: {c}')
    t = times[LEGS_BATCHES[0]]
    return dict(name='tick_legs', route='cuda',
                source='hector_torch/csrc/srb_plant.cu', replaces=None,
                launches=None,      # the loop phase's, set there
                max_abs_err=max(c['f32_kernel_gap'][-1]
                                for c in checks.values()),
                ms=t['ms'], plain_ms=t['plain_graph_ms'],
                bound_ms=t['bound_ms'], bound_by='bytes', library_ms=None)


def check_launches(phase, launches, others, periods, plant_steps=0,
                   ticks=0):
    """<false> launched once a period, the plant kernel once a tier-1 plant
    step (``plant_steps``), the leg data once a controller tick
    (``ticks``), and nothing else."""
    want = {name: n for name, n in (('plant_launches', plant_steps),
                                    ('legs_launches', ticks)) if n}
    if (launches, others) != (periods, want):
        raise RuntimeError(f'{phase}: <false> launched {launches} times and '
                           f'the other kernels {others}, expected {periods} '
                           f'and {want}')


def without_sync(name, fn):
    """fn() under torch.cuda.set_sync_debug_mode('error'): a call that
    waits on the card raises.  Returns what fn returned."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = fn()
    except RuntimeError as err:
        raise RuntimeError(f'{name} synchronises with the card: {err}')
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def estimators_phase(card, dev):
    """The tier-1 loop driven by the noisy estimators ('kf', 'filtered') at
    EST_BATCH lanes for EST_PERIODS periods, each lane walking at 0.5 m/s
    with its own noise key: the checks of tests/test_estimation.py, one
    <false> launch a period; the 'kf' tick timed and run without a
    synchronisation; the same rollout short on the card and the CPU."""
    from hector_torch import estimation as EST
    from hector_torch import prng
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG

    for kind in ('kf', 'filtered'):
        plant = srb.init_plant_state(EST_BATCH, CFG, device=dev)
        first = RT.make_rollout(EST_CHECK_PERIODS, CFG, estimator=kind)
        rest = RT.make_rollout(EST_PERIODS - EST_CHECK_PERIODS, CFG,
                               estimator=kind)
        carry = first.init(plant, prng.fold_in(
            prng.PRNGKey(7, dev), torch.arange(EST_BATCH, device=dev)))
        cmd = RT.walking_command(EST_BATCH, vx=0.5, device=dev)
        c_mid, p_mid, d_a, sec_a, _, launches, others = timed_rollout(
            first, carry, plant, cmd, EST_CHECK_PERIODS, CFG)
        carry, plant, d_b, sec_b, _, launches_b, others_b = timed_rollout(
            rest, c_mid, p_mid, cmd, EST_PERIODS - EST_CHECK_PERIODS, CFG)
        diags = {k: torch.cat([d_a[k], d_b[k]], dim=1) for k in d_a}
        sec, launches = sec_a + sec_b, launches + launches_b
        others = {k: others.get(k, 0) + others_b.get(k, 0)
                  for k in {**others, **others_b}}
        rate = EST_PERIODS * CFG.mpc.mpc_cadence * CFG.plant.dt / sec
        all_finite(est_position=plant.position, est_height=diags['height'])
        res, failed = estimator_checks(kind, diags, c_mid, p_mid)
        rec = dict(phase='estimators', estimator=kind, batch=EST_BATCH,
                   periods=EST_PERIODS, launches=launches,
                   other_launches=others, seconds=sec, sim_s_per_wall_s=rate,
                   capture_seconds=(capture_seconds(first.graphed)
                                    + capture_seconds(rest.graphed)),
                   checks=res, failed=failed, card=card)
        if kind == 'kf':
            obs = plant
            rec['kf_tick_ms'] = cuda_ms(
                lambda: EST.est_update('kf', carry.est, obs, CFG), 20)
            without_sync("est_update('kf')",
                         lambda: EST.est_update('kf', carry.est, obs, CFG))
            rec['kf_tick_synchronises'] = False
        emit(rec)
        check_launches(f'estimators ({kind})', launches, others, EST_PERIODS,
                       EST_PERIODS * CFG.mpc.mpc_cadence,
                       EST_PERIODS * CFG.mpc.mpc_cadence)
        if failed:
            raise RuntimeError(f'estimators ({kind}): {failed} failed')

        card_vs_cpu(
            'estimators_card_vs_cpu',
            lambda cfg: RT.make_rollout(EST_SHORT_PERIODS, cfg,
                                        estimator=kind),
            EST_SHORT_PERIODS, EST_SHORT_BATCH, 7,
            lambda b, d: srb.init_plant_state(b, CFG, device=d),
            lambda b, d: RT.walking_command(b, vx=0.5, device=d), dev,
            estimator=kind)


def whole_body_checks(diags, plant, walking, carry=None):
    """The checks of tests/test_whole_body.py:79-96 (cheater: standing
    lanes hold their height, walking lanes stay up and move) and :154-181
    ('kf', carry given: the estimate tracks the truth) that hold at
    WB_PERIODS periods: (measured values, failed check names)."""
    from hector_torch import math as hm
    h = diags['height'].cpu()
    fallen = diags['fallen'].cpu().any(1)
    pos = plant.position.cpu()
    res, bars = {}, {}
    if carry is None:
        stand = ~walking.cpu()
        res.update(
            fallen_lanes=int(fallen.sum()),
            stand_height_last50=[float(h[stand, -50:].mean(1).min()),
                                 float(h[stand, -50:].mean(1).max())],
            walk_min_height=float(h[~stand].min()),
            walk_min_x_final=float(pos[~stand, 0].min()))
        bars.update(
            fallen_lanes=lambda v: v == 0,
            stand_height_last50=lambda v: 0.5 < v[0] and v[1] < 0.6,
            walk_min_height=lambda v: v > 0.4,
            walk_min_x_final=lambda v: v > WB_WALK_X_MIN)
    else:
        est = carry.est.kf.x.cpu()
        v = plant.v_world.cpu()
        rpy_err = (hm.quat_to_rpy(carry.est.mahony.quat)
                   - hm.quat_to_rpy(plant.quat)).cpu()
        vy_err = (est[:, 4] - v[:, 1]).abs()
        res.update(
            fallen_lanes=int(fallen.sum()),
            min_x_final=float(pos[:, 0].min()),
            min_z_final=float(pos[:, 2].min()),
            max_z_error=float((est[:, 2] - pos[:, 2]).abs().max()),
            max_y_error=float((est[:, 1] - pos[:, 1]).abs().max()),
            max_vy_error=float(vy_err.max()),
            vy_error_share_within_bar=float((vy_err < 0.05).double().mean()),
            max_roll_pitch_error=float(rpy_err[:, :2].abs().max()),
            max_yaw_error=float(rpy_err[:, 2].abs().max()))
        # the vy estimate error at the last tick is a noisy per-tick
        # quantity, whose tail over many lanes can cross the one-lane test's
        # bar (a float32 CPU rehearsal: at most 0.028 over 4 lanes, 0.039
        # over 32): it is held on WB_VY_SHARE of the lanes, the rest on all
        bars.update(
            fallen_lanes=lambda v: v == 0,
            min_x_final=lambda v: v > WB_KF_X_MIN,
            min_z_final=lambda v: v > 0.5,
            max_z_error=lambda v: v < 0.02, max_y_error=lambda v: v < 0.03,
            vy_error_share_within_bar=lambda v: v >= WB_VY_SHARE,
            max_roll_pitch_error=lambda v: v < 0.05,
            max_yaw_error=lambda v: v < 0.08)
    return res, [k for k, ok in bars.items() if not ok(res[k])]


def whole_body_phase(card, dev):
    """make_rollout_whole_body on the card: WB_BATCH lanes for WB_PERIODS
    periods, half standing and half walking at 0.3 m/s under the cheater,
    then every lane walking at 0.5 m/s under 'kf'; the checks of
    tests/test_whole_body.py that hold at that horizon, one <false> launch
    a period; WB.step timed and run without a synchronisation; 'kf' short
    on the card and the CPU."""
    from hector_torch import prng
    from hector_torch import runtime as RT
    from hector_torch.plant import whole_body as WB
    from hector_torch.config import DEFAULT_CONFIG as CFG

    half = WB_BATCH // 2
    walking = torch.arange(WB_BATCH, device=dev) < half
    plant = WB.init_whole_body_state(0.545, WB_BATCH, device=dev)
    roll = RT.make_rollout_whole_body(WB_PERIODS, CFG)
    carry = roll.init(plant)
    cmd = RT.concat(RT.walking_command(half, vx=0.3, device=dev),
                    RT.standing_command(WB_BATCH - half, device=dev))
    carry, plant, diags, sec, rate, launches, others = timed_rollout(
        roll, carry, plant, cmd, WB_PERIODS, CFG)
    all_finite(wb_position=plant.position, wb_height=diags['height'])
    res, failed = whole_body_checks(diags, plant, walking)
    # one plant tick at this state under the controller's last command
    _, motor, _, _, _ = RT.controller_tick(
        carry, RT.whole_body_observation(plant), cmd, False, CFG)
    step_ms = cuda_ms(lambda: WB.step(plant, motor, CFG), 10)
    without_sync('WB.step', lambda: WB.step(plant, motor, CFG))
    emit(dict(phase='whole_body', estimator='cheater', batch=WB_BATCH,
              periods=WB_PERIODS, launches=launches, other_launches=others,
              seconds=sec, sim_s_per_wall_s=rate, step_ms=step_ms,
              step_synchronises=False,
              capture_seconds=capture_seconds(roll.graphed), checks=res,
              failed=failed, card=card))
    check_launches('whole_body (cheater)', launches, others, WB_PERIODS,
                   ticks=WB_PERIODS * CFG.mpc.mpc_cadence)
    if failed:
        raise RuntimeError(f'whole_body (cheater): {failed} failed')

    plant = WB.init_whole_body_state(0.545, WB_BATCH, device=dev)
    roll = RT.make_rollout_whole_body(WB_PERIODS, CFG, estimator='kf')
    carry = roll.init(plant, prng.fold_in(
        prng.PRNGKey(5, dev), torch.arange(WB_BATCH, device=dev)))
    cmd = RT.walking_command(WB_BATCH, vx=0.5, device=dev)
    carry, plant, diags, sec, rate, launches, others = timed_rollout(
        roll, carry, plant, cmd, WB_PERIODS, CFG)
    all_finite(wb_kf_position=plant.position, wb_kf_x=carry.est.kf.x)
    res, failed = whole_body_checks(diags, plant, None, carry)
    emit(dict(phase='whole_body', estimator='kf', batch=WB_BATCH,
              periods=WB_PERIODS, launches=launches, other_launches=others,
              seconds=sec, sim_s_per_wall_s=rate,
              capture_seconds=capture_seconds(roll.graphed), checks=res,
              failed=failed, card=card))
    check_launches('whole_body (kf)', launches, others, WB_PERIODS,
                   ticks=WB_PERIODS * CFG.mpc.mpc_cadence)
    if failed:
        raise RuntimeError(f'whole_body (kf): {failed} failed')

    # short, card against CPU: half walking, half standing, under 'kf'
    def short_cmd(b, d):
        return RT.concat(RT.walking_command(b // 2, vx=0.5, device=d),
                         RT.standing_command(b - b // 2, device=d))

    card_vs_cpu(
        'whole_body_card_vs_cpu',
        lambda cfg: RT.make_rollout_whole_body(WB_SHORT_PERIODS, cfg,
                                               estimator='kf'),
        WB_SHORT_PERIODS, WB_SHORT_BATCH, 5,
        lambda b, d: WB.init_whole_body_state(0.545, b, device=d), short_cmd,
        dev, estimator='kf')


def run_cli(argv):
    """hector_torch.cli.main(argv) in this process, its standard output
    captured: (what main returned, the output, seconds on the host clock,
    synchronised, launches of <false>, of every other kernel)."""
    import contextlib
    import io
    from hector_torch import cli
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = cli.main(argv)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.pop('launches', 0)
    return rec, buf.getvalue(), sec, launches, counts


def tree_to(tree, device=None, dtype=None):
    """A (nested) NamedTuple of tensors moved to ``device`` and its
    floating tensors cast to ``dtype``."""
    if isinstance(tree, tuple):
        return type(tree)(*[tree_to(x, device, dtype) for x in tree])
    if dtype is not None and tree.is_floating_point():
        tree = tree.to(dtype)
    return tree.to(device) if device is not None else tree


def tree_equal(a, b):
    """Two trees of tensors (NamedTuples, tuples, dicts) equal bit for bit:
    the same dtypes, devices, shapes and values, NaN where NaN."""
    from hector_torch.graph import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.device == y.device and x.shape == y.shape
        and (bool(torch.equal(x, y)) or (
            x.is_floating_point()
            and bool(torch.equal(torch.isnan(x), torch.isnan(y)))
            and bool(torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))))
        for x, y in zip(la, lb))


def same_as_saved(tree, saved, dev):
    """Every tensor of ``tree`` on ``dev``, with the dtype and the bits of
    the field of the same name in a checkpoint's dict."""
    if isinstance(tree, tuple):
        return all(same_as_saved(getattr(tree, k), saved[k], dev)
                   for k in tree._fields)
    return (tree.device.type == dev.type and tree.dtype == saved.dtype
            and torch.equal(tree.cpu(), saved))


def cli_phase(card, dev, work):
    """The entry-point layer on the card: the CLI's `batch` (the sharded
    rollout over the one-card mesh, the metrics log and a checkpoint), the
    same command card against CPU, a checkpoint resumed mid-run bit for
    bit, the host pipeline's stream without a synchronisation, the float64
    oracle holding both Riccati kernels, and `python -m hector_torch run`
    as a process.  ``work``: a directory of the checkout for the log and
    the checkpoints.  Every check raises."""
    import shutil
    from hector_torch import mpc as M
    from hector_torch import parallel as PAR
    from hector_torch import prng
    from hector_torch import runtime as RT
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.io import checkpoint as CKPT
    from hector_torch.io import host_pipeline as HP
    from hector_torch.io import scenarios as SC
    from hector_torch.qp import fused_riccati as FR
    from hector_torch.qp import ref_check

    shutil.rmtree(work, ignore_errors=True)
    Path(work).mkdir(parents=True)
    log, ckpt = f'{work}/batch.jsonl', f'{work}/ckpt'
    period = CFG.mpc.dt * CFG.mpc.mpc_cadence

    # ---- batch at full width: 200 <false> and 1,000 plant launches ----
    periods = int(CLI_SECONDS / period)
    rec, out, sec, launches, others = run_cli(
        ['batch', '--batch', str(CLI_BATCH), '--seconds', str(CLI_SECONDS),
         '--seed', '0', '--log', log, '--checkpoint', ckpt])
    logged = [json.loads(line) for line in open(log)]
    printed = json.JSONDecoder().raw_decode(out)[0]
    metrics = {k: rec[k] for k in ('mean_height', 'fallen_count',
                                   'qp_mu_max')}
    emit(dict(phase='cli', command='batch', batch=CLI_BATCH,
              periods=periods, launches=launches, other_launches=others,
              seconds=sec, sim_s_per_wall_s=CLI_SECONDS / sec,
              record=rec, card=card))
    check_launches('cli batch', launches, others, periods,
                   periods * CFG.mpc.mpc_cadence,
                   periods * CFG.mpc.mpc_cadence)
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f'cli batch: metrics not finite: {metrics}')
    if not CLI_HEIGHT_BAND[0] < rec['mean_height'] < CLI_HEIGHT_BAND[1]:
        raise RuntimeError(f"cli batch: mean height {rec['mean_height']} "
                           f'out of {CLI_HEIGHT_BAND}')
    if logged != [rec] or printed != rec or rec['devices'] != 1.0:
        raise RuntimeError(f'cli batch: the log {logged}, the printed '
                           f'record {printed} and the record {rec} differ')

    # ---- the same command, short, card against CPU ----
    short = ['batch', '--batch', str(CLI_SHORT_BATCH), '--seconds',
             str(CLI_SHORT_SECONDS), '--seed', '0']
    rec_k, _, _, launches, others = run_cli(short)
    rec_c, _, _, _, _ = run_cli(['--device', 'cpu'] + short)
    d_h = abs(rec_k['mean_height'] - rec_c['mean_height'])
    d_mu = abs(rec_k['qp_mu_max'] / rec_c['qp_mu_max'] - 1.0)
    emit(dict(phase='cli_card_vs_cpu', batch=CLI_SHORT_BATCH,
              periods=int(CLI_SHORT_SECONDS / period), card_record=rec_k,
              cpu_record=rec_c, abs_mean_height=d_h, rel_qp_mu_max=d_mu))
    short = int(CLI_SHORT_SECONDS / period)
    check_launches('cli batch (short)', launches, others, short,
                   short * CFG.mpc.mpc_cadence, short * CFG.mpc.mpc_cadence)
    if not (d_h <= CLI_HEIGHT_TOL and d_mu <= CLI_MU_RTOL
            and rec_k['fallen_count'] == rec_c['fallen_count']):
        raise RuntimeError(f'cli card vs cpu: mean height {d_h} m (bar '
                           f'{CLI_HEIGHT_TOL}), qp_mu_max {d_mu} (bar '
                           f'{CLI_MU_RTOL}), fallen {rec_k["fallen_count"]} '
                           f'against {rec_c["fallen_count"]}')

    # ---- checkpoint: restored on the card bit for bit, resumed mid-run ----
    template = PAR.make_batch(CLI_BATCH, device=dev)
    step, restored = CKPT.restore(ckpt, template)
    saved = torch.load(f'{ckpt}/{step}/{CKPT.FILE}', weights_only=True)
    state = tuple(restored[k] for k in ('carry', 'plant', 'cmd'))
    exact = step == periods and all(
        same_as_saved(x, saved[k], dev)
        for k, x in zip(('carry', 'plant', 'cmd'), state))
    roll = RT.make_rollout(RESUME_PERIODS, CFG)
    c_mid, p_mid, _ = roll(*state)
    CKPT.save(f'{work}/resume', periods + RESUME_PERIODS, c_mid, p_mid,
              state[2])
    c_on, p_on, d_on = roll(c_mid, p_mid, state[2])
    _, again = CKPT.restore(f'{work}/resume', template)
    c_re, p_re, d_re = roll(again['carry'], again['plant'], again['cmd'])
    resumed = (tree_equal(c_on, c_re) and tree_equal(p_on, p_re)
               and all(torch.equal(d_on[k], d_re[k]) for k in d_on))
    emit(dict(phase='cli_checkpoint', batch=CLI_BATCH, step=step,
              restored_bit_for_bit=exact, resume_periods=RESUME_PERIODS,
              resumed_bit_for_bit=resumed))
    if not (exact and resumed):
        raise RuntimeError(f'checkpoint: restored exactly {exact}, resumed '
                           f'exactly {resumed}')

    # ---- the host pipeline: the stream's batches, next() without a sync ----
    stream = HP.ScenarioStream(STREAM_BATCH, seed=7, device=dev)
    batches = []
    for _ in range(STREAM_STEPS):
        without_sync('ScenarioStream.__next__',
                     lambda: batches.append(next(stream)))
    rows_equal = all(
        torch.equal(torch.stack(list(cmd[:5]) + [cmd.terrain_step_height,
                                                 cmd.terrain_step_length], 1)
                    .cpu(), torch.from_numpy(
                        HP.generate_host(7 + (k << 32), STREAM_BATCH)
                        [:, [0, 1, 2, 3, 4, 9, 10]]))
        and torch.equal(cmd.gait_offsets.cpu(), torch.from_numpy(
            HP.generate_host(7 + (k << 32), STREAM_BATCH)[:, 5:7]))
        for k, cmd in enumerate(batches))
    one = RT.make_rollout(1, CFG)
    plant = PAR.make_batch(STREAM_BATCH, device=dev)[1]
    carry = RT.init_controller_carry(plant, CFG)

    def timed_period(in_flight):
        cmd = next(stream)
        if not in_flight:
            stream.wait()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(carry, plant, cmd)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed_period(True)                      # warm-up
    times = {True: [], False: []}
    for in_flight in (True, False) * STREAM_TIMED:
        times[in_flight].append(timed_period(in_flight))
    stream.close()
    emit(dict(phase='cli_stream', batch=STREAM_BATCH, steps=STREAM_STEPS,
              rows_equal_generate_host=rows_equal, next_synchronises=False,
              period_ms_next_in_flight=times[True],
              period_ms_nothing_in_flight=times[False], card=card))
    if not rows_equal:
        raise RuntimeError("ScenarioStream: a batch differs from "
                           "generate_host's rows")

    # ---- the float64 oracle holds both Riccati kernels ----
    carry, plant, cmd = scenarios(ORACLE_LANES, 17, dev)
    parts = state_problem(carry, plant, cmd, M.build_parts)
    q_diag, r_diag = tuple(CFG.mpc.weights) + (0.0,), tuple(CFG.mpc.alpha)
    pcfg = dataclasses.replace(CFG.solver, polish_rounds=POLISH_ROUNDS)
    sol = FR.solve_parts(parts, CFG.solver, q_diag, r_diag)
    pol = FR.solve_parts(parts, pcfg, q_diag, r_diag)
    off = FR.solve_parts(parts, dataclasses.replace(pcfg, polish_tol=-1.0),
                         q_diag, r_diag)
    accepted = (pol.u != off.u).any(1).cpu()
    state64 = [tree_to(x, 'cpu', torch.float64) for x in (carry, plant, cmd)]
    qp = state_problem(*state64, M.build_dense)
    x_opt = torch.from_numpy(ref_check.solve_qpdata(qp))
    du = (sol.u.cpu().double() - x_opt).abs().amax(1)
    du_pol = (pol.u.cpu().double() - x_opt).abs().amax(1)
    err, err_pol = float(du.max()), float(du_pol[accepted].max())
    emit(dict(phase='cli_oracle', lanes=ORACLE_LANES,
              max_abs_du_false=err, bar_false=ORACLE_TOL,
              accepted_lanes=int(accepted.sum()),
              max_abs_du_true_accepted=err_pol, bar_true=ORACLE_POLISH_TOL,
              force_scale=float(x_opt.abs().max()), card=card))
    if not (err <= ORACLE_TOL and err_pol <= ORACLE_POLISH_TOL
            and bool(accepted.any())):
        raise RuntimeError(f'oracle: <false> {err} N (bar {ORACLE_TOL}), '
                           f'<true> {err_pol} N on {int(accepted.sum())} '
                           f'accepted lanes (bar {ORACLE_POLISH_TOL})')

    # ---- the module entry point as a process ----
    t0 = time.perf_counter()
    # from this script's checkout, so that `-m` finds its hector_torch
    proc = subprocess.run([sys.executable, '-m', 'hector_torch', 'run',
                           '--seconds', '0.5'],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=300)
    sec = time.perf_counter() - t0
    ok = proc.returncode == 0
    rec = json.JSONDecoder().raw_decode(proc.stdout)[0] if ok else None
    emit(dict(phase='cli_module', command='python -m hector_torch run '
              '--seconds 0.5', returncode=proc.returncode, seconds=sec,
              record=rec))
    if not ok or list(rec) != RUN_KEYS or not all(
            math.isfinite(v) for v in rec.values()):
        raise RuntimeError(f'python -m hector_torch run: rc '
                           f'{proc.returncode}, {rec}, {proc.stderr[-2000:]}')
    shutil.rmtree(work, ignore_errors=True)


def bench_phase(card, main_solves_per_s):
    """`python -m hector_torch bench` in this process at its full shape
    (bench.BATCH lanes, bench.CHAIN_LEN steps, bench.REPS timed chains after
    one not timed): one <false> launch a step and nothing else, the record
    with bench.py's keys in its order, a finite positive value within
    BENCH_VS_MAIN of the `main` phase's solves/s."""
    from hector_torch import bench
    rec, out, sec, launches, others = run_cli(['bench'])
    value = rec['value']
    ratio = value / main_solves_per_s
    emit(dict(phase='bench', record=rec, seconds=sec, launches=launches,
              other_launches=others, main_solves_per_s=main_solves_per_s,
              bench_over_main=ratio, card=card))
    check_launches('bench', launches, others,
                   (1 + bench.REPS) * bench.CHAIN_LEN,
                   ticks=(1 + bench.REPS) * bench.CHAIN_LEN)
    if list(rec) != BENCH_KEYS or [json.loads(line) for line in
                                   out.splitlines()] != [rec]:
        raise RuntimeError(f'bench printed {out!r}, not one record with the '
                           f'keys {BENCH_KEYS}')
    if not (math.isfinite(value) and value > 0):
        raise RuntimeError(f'bench: value {value}')
    if not BENCH_VS_MAIN[0] <= ratio <= BENCH_VS_MAIN[1]:
        raise RuntimeError(f'bench: {value} solves/s is {ratio} x the main '
                           f'phase\'s {main_solves_per_s}, outside '
                           f'{BENCH_VS_MAIN}')


def multihost_phase(card, work):
    """parallel.multihost over NCCL on one card: a one-process group
    (file:// rendezvous under ``work``), make_batch(MULTIHOST_BATCH) over its
    mesh and a MULTIHOST_PERIODS-period sharded rollout, against the same
    run without a group: the mesh the current card, one <false> launch a
    period, one plant launch a tick and nothing else, every tensor
    all_reduce sees on that card,
    the metrics and the final state bit for bit."""
    import tempfile
    import torch.distributed as dist
    from hector_torch import parallel as PAR
    from hector_torch.config import DEFAULT_CONFIG as CFG

    def rollout(mesh):
        return timed_rollout(
            PAR.make_sharded_rollout(MULTIHOST_PERIODS, mesh, CFG),
            *PAR.make_batch(MULTIHOST_BATCH, cfg=CFG, mesh=mesh),
            MULTIHOST_PERIODS, CFG)

    alone = rollout(PAR.data_mesh(1))
    reduced = []
    all_reduce = dist.all_reduce

    def recording(tensor, *args, **kwargs):
        reduced.append(tensor.device)
        return all_reduce(tensor, *args, **kwargs)

    Path(work).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        mesh = PAR.multihost(f'file://{tmp}/rdv', num_processes=1,
                             process_id=0)
        try:
            backend = dist.get_backend()
            dist.all_reduce = recording
            grouped = rollout(mesh)
        finally:
            dist.all_reduce = all_reduce
            dist.destroy_process_group()
    own = torch.device('cuda', torch.cuda.current_device())
    _, plant_a, metrics_a = alone[:3]
    _, plant_g, metrics_g, sec, sim_rate, launches, others = grouped
    same = (tree_equal(PAR.gather(plant_a), PAR.gather(plant_g))
            and metrics_a.keys() == metrics_g.keys()
            and all(tree_equal(metrics_a[k], metrics_g[k])
                    for k in metrics_a))
    emit(dict(phase='multihost', backend=backend, mesh=[str(d) for d in mesh],
              batch=MULTIHOST_BATCH, periods=MULTIHOST_PERIODS,
              launches=launches, reduced_on=sorted({str(d) for d in reduced}),
              bit_for_bit=same, seconds=sec, sim_s_per_wall_s=sim_rate,
              seconds_without_group=alone[3],
              metrics={k: float(v) for k, v in metrics_g.items()},
              card=card))
    check_launches('multihost', launches, others, MULTIHOST_PERIODS,
                   MULTIHOST_PERIODS * CFG.mpc.mpc_cadence,
                   MULTIHOST_PERIODS * CFG.mpc.mpc_cadence)
    if backend != 'nccl' or mesh != (own,):
        raise RuntimeError(f'multihost: backend {backend}, mesh {mesh}, '
                           f'expected nccl on {own}')
    if len(reduced) != 2 or any(d != own for d in reduced):
        raise RuntimeError(f'multihost: all_reduce on {reduced}, expected '
                           f'two tensors on {own}')
    if not all(v.device == own for v in metrics_g.values()):
        raise RuntimeError('multihost: metrics off the rank\'s card')
    if not same:
        raise RuntimeError('multihost: the run in a group is not bit for bit '
                           'the run without one')


def capture_seconds(steps):
    """Seconds that a graph.StepGraph spent in warm-up and capture."""
    return sum(cap.seconds for cap in steps.captures.values())


def graph_nodes(steps):
    """The nodes of each CUDA graph a graph.StepGraph captured (one step
    each), read with libcuda's cuGraphGetNodes."""
    import ctypes
    lib = ctypes.CDLL('libcuda.so.1')
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    out = []
    for cap in steps.captures.values():
        n = ctypes.c_size_t(0)
        rc = lib.cuGraphGetNodes(cap.graph.raw_cuda_graph(), None,
                                 ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f'cuGraphGetNodes failed: CUresult {rc}')
        out.append(n.value)
    return out


def device_events(prof):
    """The device activities (kernels, copies, fills) of a torch.profiler
    run, as (name, start us, duration us)."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.name, evt.time_range.start,
                        evt.time_range.end - evt.time_range.start))
    return out


def idle_share(events):
    """1 - (time some device activity runs) / (first start to last end)."""
    spans = sorted((t0, t0 + d) for _, t0, d in events)
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span = spans[-1][1] - spans[0][0]
    return 1.0 - busy / span, span


class WrapperPointers:
    """Records whether each tensor the dense interior point hands the
    Cholesky wrappers (and each they return) starts on 16 bytes, the
    address test by which the tile and cluster kernels take their float4
    path (chol.cu vec_ok), split by where the call ran: 'capture' (the
    step being recorded) or 'eager' (a warm-up or an eager run)."""

    def __init__(self):
        self.seen = {}

    def _note(self, *tensors):
        where = ('capture' if torch.cuda.is_current_stream_capturing()
                 else 'eager')
        for t in tensors:
            key = (where, t.data_ptr() % 16 == 0)
            self.seen[key] = self.seen.get(key, 0) + 1

    def __enter__(self):
        from hector_torch.qp import chol as CH
        self.fns = factor_fn, solve_fn = CH.cholesky_bnn, CH.cholesky_solve_bnn

        def factor(m):
            ell = factor_fn(m)
            self._note(m, ell)
            return ell

        def solve(ell, rhs):
            x = solve_fn(ell, rhs)
            self._note(ell, rhs, x)
            return x

        CH.cholesky_bnn, CH.cholesky_solve_bnn = factor, solve
        return self

    def __exit__(self, *exc):
        from hector_torch.qp import chol as CH
        CH.cholesky_bnn, CH.cholesky_solve_bnn = self.fns

    def summary(self):
        """{where: {'aligned16': n, 'not_aligned16': n}}."""
        out = {}
        for (where, ok), count in sorted(self.seen.items()):
            out.setdefault(where, {})['aligned16' if ok else
                                      'not_aligned16'] = count
        return out


def graph_case(name, steps, run_graph, run_eager, steps_per_call, unit_s,
               launches=None):
    """One captured path against its eager run on the card, same inputs:
    the graph's first call (warm-up, capture, replays), a second call
    under set_sync_debug_mode('error'), the eager run, each timed on the
    host clock (synchronised), held bit for bit; the launches of the
    second call and of the eager run (launch_counts) both ``launches``
    (default: one <false> a step); the nodes of the captured step; the
    peak device memory of the first call and of the eager run above what
    was allocated before each; the
    alignment of what the Cholesky wrappers saw (WrapperPointers).
    Emits the record and returns it."""

    def timed(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return (out, sec, launch_counts(),
                torch.cuda.max_memory_allocated() - held)

    with WrapperPointers() as pointers:
        first, first_s, _, peak = timed(run_graph)
        cap_s = capture_seconds(steps)
        out_g, graph_s, graph_l, _ = timed(
            lambda: without_sync(f'{name} (graph replays)', run_graph))
        out_e, eager_s, eager_l, eager_peak = timed(run_eager)
    (nodes,) = graph_nodes(steps)
    same = tree_equal(out_g, out_e) and tree_equal(first, out_g)
    rec = dict(phase='graph', path=name, steps=steps_per_call,
               captures=len(steps.captures), capture_seconds=cap_s,
               first_call_seconds=first_s, graph_seconds=graph_s,
               eager_seconds=eager_s, graph_over_eager=eager_s / graph_s,
               graph_launches=graph_l, eager_launches=eager_l,
               graph_nodes=nodes, peak_bytes=peak,
               eager_peak_bytes=eager_peak,
               cholesky_wrapper_pointers=pointers.summary(), bit_equal=same)
    if unit_s:
        rec.update(graph_sim_s_per_wall_s=steps_per_call * unit_s / graph_s,
                   eager_sim_s_per_wall_s=steps_per_call * unit_s / eager_s)
    emit(rec)
    if not same:
        raise RuntimeError(f'graph {name}: the replayed run is not bit for '
                           f'bit the eager run')
    expected = {'launches': steps_per_call} if launches is None else launches
    if graph_l != eager_l or graph_l != expected:
        raise RuntimeError(f'graph {name}: launches {graph_l} replayed, '
                           f'{eager_l} eager, expected {expected}')
    if len(steps.captures) != 1:
        raise RuntimeError(f'graph {name}: {len(steps.captures)} captures '
                           f'of one signature')
    return rec


def trace_replays(card, path, batch, run, steps, rec, out):
    """One torch.profiler trace (hector_torch.io.profiling.trace, into
    ``out``) of ``run``, a warmed-up captured path of ``steps`` replayed
    steps, beside ``rec``, the graph_case record of the same path (its
    replays ran without the profiler): the device activities and time a
    step, the card's idle share in the profiled span and against the
    unprofiled wall time, the top device ops a step.  Emits the record."""
    from hector_torch.io import profiling
    run()
    torch.cuda.synchronize()
    with profiling.trace(str(out)) as prof:
        run()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        raise RuntimeError(f'graph: the trace of replayed {path} holds no '
                           f'device activity')
    idle, span = idle_share(events)
    by_name = {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:GRAPH_TOP_OPS]
    busy_ms = sum(by_name.values()) / 1e3 / steps
    wall_ms = rec['graph_seconds'] * 1e3 / rec['steps']
    emit(dict(phase='graph_trace', path=path, batch=batch, steps=steps,
              device_events_per_step=len(events) / steps,
              device_ms_per_step=busy_ms,
              span_ms_per_step=span / 1e3 / steps, idle_share=idle,
              unprofiled_wall_ms_per_step=wall_ms,
              unprofiled_idle_share=1.0 - busy_ms / wall_ms,
              top_ops_us_per_step=[(name, d / steps) for name, d in top],
              trace=str(out / 'trace.json'), card=card))


def graph_phase(card, dev, work):
    """Each captured path against its eager run on the card (graph_case):
    the tier-1 loop, the robustness rollout, the 'kf' and 'filtered' loops,
    the tier-2 loop under the cheater, the chained planning step (with and
    without the polish); the dense interior point's period under
    'dense_auto', 'xla' and 'pallas_interpret', its chained step, its
    horizon-24 batch solve (pdip.make_solver) alone and inside a captured
    step; the stage solver 'riccati': its period, its chained step and its
    horizon-24 batch solve (riccati.make_solver, with its gaps to the
    float64 stage solver and to the dense solve); torch.profiler traces of
    the dense and stage steps' and the dense solve's replays and of
    replayed tier-1 periods (trace_replays)."""
    from hector_torch import bench, graph, prng
    from hector_torch import mpc as M
    from hector_torch import runtime as RT
    from hector_torch.qp import pdip as PD
    from hector_torch.qp import riccati as TR
    from hector_torch.plant import srb
    from hector_torch.plant import whole_body as WB
    from hector_torch.config import DEFAULT_CONFIG as CFG

    n, b = GRAPH_PERIODS, LOOP_BATCH
    half = b // 2
    period_s = CFG.mpc.mpc_cadence * CFG.plant.dt
    keys = prng.fold_in(prng.PRNGKey(7, dev), torch.arange(b, device=dev))
    mixed = RT.concat(RT.walking_command(half, vx=0.5, device=dev),
                      RT.standing_command(b - half, device=dev))
    walk = RT.walking_command(b, vx=0.5, device=dev)
    recs = []

    def rollout_case(name, roll, plant, args, key=None, periods=n,
                     launches=None, tier1=True):
        """``launches``: of the solver's kernels (default one <false> a
        period); every tick adds one launch of the leg data, and a tier-1
        loop one plant kernel a tick."""
        carry = roll.init(plant, key)
        want = {'launches': periods} if launches is None else dict(launches)
        want['legs_launches'] = CFG.mpc.mpc_cadence * periods
        if tier1:
            want['plant_launches'] = CFG.mpc.mpc_cadence * periods
        recs.append(graph_case(
            name, roll.graphed, lambda: roll(carry, plant, *args),
            lambda: roll.eager(carry, plant, *args), periods, period_s,
            want))

    plant = srb.init_plant_state(b, CFG, device=dev)
    rollout_case('loop', RT.make_rollout(n, CFG), plant, (mixed,))
    _, cmd, dist, sched = robust_inputs(b, n, GRAPH_ROBUST_EVENTS, dev)
    rollout_case('robust', RT.make_rollout(n, CFG, with_disturbance=True,
                                           with_schedule=True),
                 plant, (cmd, dist, sched))
    for kind in ('kf', 'filtered'):
        rollout_case(f'estimators ({kind})',
                     RT.make_rollout(n, CFG, estimator=kind), plant, (walk,),
                     keys)
    rollout_case('whole_body (cheater)', RT.make_rollout_whole_body(n, CFG),
                 WB.init_whole_body_state(0.545, b, device=dev), (mixed,),
                 tier1=False)

    carry, plant, cmd = bench.initial_state(MAIN_BATCH, device=dev)
    plan = RT.plan_step_fn(CFG)
    chained = bench.make_chain(plan, MAIN_CHAIN).steps
    recs.append(graph_case(
        'plan_step', chained, lambda: chained((carry, plant), cmd),
        lambda: chain(plan, carry, plant, cmd, MAIN_CHAIN)[:2],
        MAIN_CHAIN, None, launches={'launches': MAIN_CHAIN,
                                    'legs_launches': MAIN_CHAIN}))
    plan_p = RT.plan_step_fn(with_solver(CFG, polish_rounds=POLISH_ROUNDS))
    chained_p = bench.make_chain(plan_p, POLISH_CHAIN).steps
    recs.append(graph_case(
        'plan_step (polish)', chained_p,
        lambda: chained_p((carry, plant), cmd),
        lambda: chain(plan_p, carry, plant, cmd, POLISH_CHAIN)[:2],
        POLISH_CHAIN, None, launches={'polish_launches': POLISH_CHAIN,
                                      'legs_launches': POLISH_CHAIN}))

    # the dense interior point: a period under each of its backends (the
    # kernels at 1,024 lanes, torch.linalg likewise, the plain versions at
    # a few lanes: their loops make a period of some 50,000 nodes), the
    # chained step, the horizon-24 batch solve and that solve inside a
    # step that is itself captured
    it = CFG.solver.iterations
    dense_step = {'factor_launches': it + 1, 'solve_launches': 2 * it + 1}
    dense_plan_step = {**dense_step, 'legs_launches': 1}

    def times(k, counts):
        return {name: k * v for name, v in counts.items()}

    dense = with_solver(CFG, backend='dense_auto')
    plant = srb.init_plant_state(b, CFG, device=dev)
    rollout_case('dense_loop (dense_auto)', RT.make_rollout(n, dense), plant,
                 (mixed,), launches=times(n, dense_step))
    rollout_case("dense_loop ('xla')",
                 RT.make_rollout(n, with_solver(CFG, backend='xla')), plant,
                 (mixed,), launches={})
    small = GRAPH_SMALL_BATCH
    rollout_case("dense_loop ('pallas_interpret')",
                 RT.make_rollout(GRAPH_SMALL_PERIODS, with_solver(
                     CFG, backend='pallas_interpret')),
                 srb.init_plant_state(small, CFG, device=dev),
                 (RT.walking_command(small, vx=0.5, device=dev),),
                 periods=GRAPH_SMALL_PERIODS, launches={})
    # the Mehrotra stage solver: its period (torch.linalg calls, no kernel
    # of the port)
    stage = with_solver(CFG, backend='riccati')
    rollout_case("riccati_loop ('riccati')", RT.make_rollout(n, stage),
                 plant, (mixed,), launches={})

    carry, plant, cmd = bench.initial_state(DENSE_BATCH, device=dev)
    plan_d = RT.plan_step_fn(dense)
    chained_d = bench.make_chain(plan_d, DENSE_CHAIN).steps
    recs.append(graph_case(
        'plan_step (dense)', chained_d, lambda: chained_d((carry, plant), cmd),
        lambda: chain(plan_d, carry, plant, cmd, DENSE_CHAIN)[:2],
        DENSE_CHAIN, None, launches=times(DENSE_CHAIN, dense_plan_step)))
    trace_replays(card, 'plan_step (dense)', DENSE_BATCH,
                  lambda: chained_d((carry, plant), cmd), DENSE_CHAIN,
                  recs[-1], work / 'trace_dense_step')
    carry, plant, cmd = bench.initial_state(RICCATI_BATCH, device=dev)
    plan_r = RT.plan_step_fn(stage)
    chained_r = bench.make_chain(plan_r, RICCATI_CHAIN).steps
    recs.append(graph_case(
        'plan_step (riccati)', chained_r,
        lambda: chained_r((carry, plant), cmd),
        lambda: chain(plan_r, carry, plant, cmd, RICCATI_CHAIN)[:2],
        RICCATI_CHAIN, None, launches={'legs_launches': RICCATI_CHAIN}))
    trace_replays(card, 'plan_step (riccati)', RICCATI_BATCH,
                  lambda: chained_r((carry, plant), cmd), RICCATI_CHAIN,
                  recs[-1], work / 'trace_riccati_step')
    del carry, plant, cmd, chained_r

    long_cfg = dataclasses.replace(dense, mpc=dataclasses.replace(
        CFG.mpc, horizon=LONG_HORIZON))
    long_scfg = dataclasses.replace(long_cfg.solver, backend='auto')
    long_state = scenarios(LONG_BATCH, 10, dev)
    qp_long = state_problem(*long_state, M.build_dense, long_cfg)
    long_step = {**dense_step, 'factor_cluster_launches': it + 1,
                 'solve_stream_launches': 2 * it + 1}
    solver = PD.make_solver(long_scfg)
    recs.append(graph_case(
        'make_solver (h=24)', solver.steps, lambda: solver(qp_long),
        lambda: M.solve(qp_long, long_cfg), 1, None, launches=long_step))
    trace_replays(card, 'make_solver (h=24)', LONG_BATCH,
                  lambda: solver(qp_long), 1, recs[-1],
                  work / 'trace_dense_long')
    # the solve captures a graph of its own in the outer step's warm-up
    # and is solve_batched inside the outer recording
    inner = PD.make_solver(long_scfg)
    outer = graph.StepGraph(lambda state, qp, i: (state, inner(qp)), 1)
    recs.append(graph_case(
        'make_solver (h=24) inside a captured step', outer,
        lambda: outer((), qp_long),
        lambda: ((), PD.QPSolution(*[
            x[:, None] for x in PD.solve_batched(qp_long, long_scfg)])),
        1, None, launches=long_step))
    if len(inner.steps.captures) != 1:
        raise RuntimeError('graph: the solve inside a captured step made '
                           f'{len(inner.steps.captures)} captures of its own')
    u_dense = solver(qp_long).u
    del solver, inner, outer, qp_long

    # the stage solver's horizon-24 batch solve (riccati.make_solver) on
    # the same scenarios, and its gaps to the float64 stage solver and to
    # the captured dense solve: records, not gates
    long_r = with_solver(long_cfg, backend='riccati')
    sqp_long = state_problem(*long_state, M.build_stage, long_r)
    solver_r = TR.make_solver(long_r.solver)
    recs.append(graph_case(
        'make_solver (riccati, h=24)', solver_r.steps,
        lambda: solver_r(sqp_long), lambda: M.solve(sqp_long, long_r), 1,
        None, launches={}))
    u_r = solver_r(sqp_long).u
    u_64 = TR.solve_batched(TR.StageQPData(*[x.double() for x in sqp_long]),
                            long_r.solver).u
    all_finite(riccati_long_u=u_r, riccati_long_u64=u_64)

    def gap(a, b):
        d = (a.double() - b.double()).abs()
        return float(d.max()), float(d[:, :12].max())

    emit(dict(phase='graph_gaps', path='make_solver (riccati, h=24)',
              batch=LONG_BATCH, horizon=LONG_HORIZON,
              max_abs_u_vs_f64_stage=gap(u_r, u_64)[0],
              max_abs_wrench_vs_f64_stage=gap(u_r, u_64)[1],
              max_abs_u_vs_dense_captured=gap(u_r, u_dense)[0],
              max_abs_wrench_vs_dense_captured=gap(u_r, u_dense)[1],
              u_scale=float(u_64.abs().max()), card=card))
    del solver_r, sqp_long, long_state, u_r, u_64, u_dense

    # one trace of replayed tier-1 periods
    roll = RT.make_rollout(GRAPH_TRACE_PERIODS, CFG)
    plant = srb.init_plant_state(b, CFG, device=dev)
    carry = roll.init(plant)
    # the loop case's replays ran without the profiler: its wall time a
    # period against the device time a period the trace shows
    trace_replays(card, 'loop', b, lambda: roll(carry, plant, mixed),
                  GRAPH_TRACE_PERIODS, recs[0], work / 'trace')
    return recs


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import bench, cuda
    from hector_torch import mpc as M
    from hector_torch import runtime as RT
    from hector_torch.plant import srb
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.cuda import counts as LC      # the launch counts
    from hector_torch.qp import chol as CH
    from hector_torch.qp import fused_riccati as FR
    from hector_torch.qp import pdip as PD

    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    scfg = CFG.solver
    pcfg = dataclasses.replace(scfg, polish_rounds=POLISH_ROUNDS)
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)

    # ---- build: one nvcc per source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for fut in [pool.submit(lib.load)
                    for lib in (cuda.FUSED, cuda.CHOL, cuda.SRB)]:
            fut.result()
    build_s = time.perf_counter() - t0
    ptxas = {}
    nvcc_seconds = {}
    for lib in (cuda.FUSED, cuda.CHOL, cuda.SRB):
        for name, info in lib.build_info.items():
            ptxas.update(parse_ptxas(info.get('ptxas', '')))
            nvcc_seconds[name] = info.get('seconds')
    n = 12 * CFG.mpc.horizon            # the dense path's KKT matrices
    n_long = 12 * LONG_HORIZON
    # each Cholesky kernel at the n of the path it serves
    attrs = {'fused_riccati': FR.kernel_attributes('warp'),
             'fused_riccati_polish': FR.kernel_attributes('polish'),
             'chol_factor': CH.kernel_attributes(n, 'factor_tile'),
             'chol_factor_shared': CH.kernel_attributes(n_long,
                                                        'factor_shared'),
             'chol_factor_cluster': CH.kernel_attributes(n_long,
                                                         'factor_cluster'),
             'chol_solve': CH.kernel_attributes(n, 'solve_tile'),
             'chol_solve_shared': CH.kernel_attributes(n_long,
                                                       'solve_shared'),
             'chol_solve_stream': CH.kernel_attributes(n_long,
                                                       'solve_stream')}
    plant_attrs = {'srb_plant': srb.kernel_attributes(torch.float32),
                   'srb_plant_f64': srb.kernel_attributes(torch.float64)}
    legs_attrs = {
        'tick_legs': srb.kernel_attributes(torch.float32, 'tick_legs'),
        'tick_legs_f64': srb.kernel_attributes(torch.float64, 'tick_legs')}
    emit(dict(phase='build', seconds=build_s, card=card,
              nvcc_seconds=nvcc_seconds, ptxas=ptxas,
              attributes={**attrs, **plant_attrs, **legs_attrs}))
    # the plant and leg-data kernels' precise sin/cos/asin/acos keep a
    # stack frame for their slow argument reduction; nothing may spill
    for name in (*plant_attrs, *legs_attrs):
        rep = ptxas.get(name, {})
        if not (rep and rep['spill_store_bytes'] == 0
                and rep['spill_load_bytes'] == 0):
            raise RuntimeError(f'{name} spills: {rep}')
    for name, attr in attrs.items():
        rep = ptxas.get(name, {})
        if not (rep and rep['spill_store_bytes'] == 0
                and rep['spill_load_bytes'] == 0
                and rep['stack_frame_bytes'] == 0
                and attr['local_bytes'] == 0):
            raise RuntimeError(f'{name} uses local memory: {rep}, {attr}')
    if attrs['chol_factor_cluster']['registers'] > CLUSTER_MAX_REGISTERS:
        raise RuntimeError(f'the cluster factor takes more than '
                           f'{CLUSTER_MAX_REGISTERS} registers: '
                           f'{attrs["chol_factor_cluster"]}')
    if attrs['chol_solve_stream']['blocks_per_sm'] < STREAM_BLOCKS_PER_SM:
        raise RuntimeError(f'the streaming solve holds fewer than '
                           f'{STREAM_BLOCKS_PER_SM} blocks an SM at n = '
                           f'{n_long}: {attrs["chol_solve_stream"]}')
    ip_attr = attrs['fused_riccati']
    if not (ip_attr['registers'] <= IP_MAX_REGISTERS
            and ip_attr['warps_per_sm'] >= IP_WARPS_PER_SM):
        raise RuntimeError(f'the kernel without polish takes '
                           f'{ip_attr["registers"]} registers and '
                           f'{ip_attr["warps_per_sm"]} warps an SM, not '
                           f'<= {IP_MAX_REGISTERS} and {IP_WARPS_PER_SM}')

    plant_entry = plant_phase(card, dev, ptxas, plant_attrs)
    legs_entry = legs_phase(card, dev, ptxas, legs_attrs)

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
    # the default 'auto' is the kernel on the card and the Mehrotra stage
    # solver on the CPU, so the CPU side names the fused solver: its plain
    # version, the same algorithm
    carry, plant, cmd = scenarios(256, 4, dev)
    plan = RT.plan_step_fn(CFG)
    plan_fused = RT.plan_step_fn(with_solver(CFG, backend='riccati_pallas'))
    _, w_gpu, m_gpu = plan(carry, plant, cmd)
    _, w_cpu, m_cpu = plan_fused(to_cpu(carry), to_cpu(plant), to_cpu(cmd))
    step_err = max(float((w_gpu.cpu() - w_cpu).abs().max()),
                   float((m_gpu.tau.cpu() - m_cpu.tau).abs().max()))
    emit(dict(phase='check', batch=256, cpu_backend='riccati_pallas',
              max_abs_diff=step_err, wrench_scale=float(w_cpu.abs().max())))
    if not (math.isfinite(step_err) and step_err <= STEP_TOL):
        raise RuntimeError(f'card vs CPU planning step differs by {step_err}')
    # the reference's interpreted-kernel name: the plain solver on the card
    fr_before = LC.launches + LC.polish_launches
    plan_int = RT.plan_step_fn(
        with_solver(CFG, backend='riccati_pallas_interpret'))
    _, w_int, m_int = plan_int(carry, plant, cmd)
    torch.cuda.synchronize()
    int_launches = LC.launches + LC.polish_launches - fr_before
    int_err = max(float((w_int.cpu() - w_cpu).abs().max()),
                  float((m_int.tau.cpu() - m_cpu.tau).abs().max()))
    emit(dict(phase='check', batch=256, backend='riccati_pallas_interpret',
              launches=int_launches, max_abs_diff=int_err))
    if int_launches or not (math.isfinite(int_err) and int_err <= STEP_TOL):
        raise RuntimeError(f"'riccati_pallas_interpret' on the card launched "
                           f'{int_launches} kernels and differs from the CPU '
                           f'step by {int_err}')

    # ---- the Mehrotra stage solver on the card ----
    riccati_phase(card, dev)

    # ---- main path: chained planning steps at full width ----
    plant = srb.init_plant_state(MAIN_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.walking_command(MAIN_BATCH, vx=0.5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    plant = plant._replace(position=plant.position + 1e-6 * torch.rand(
        plant.position.shape, generator=gen, device=dev))
    main_state = (carry, plant, cmd)    # reused by the polish path

    # the path as a user runs it: the chained step captured as a CUDA
    # graph (bench.make_chain) and replayed; the eager chain beside it
    chained = bench.make_chain(plan, MAIN_CHAIN).steps
    chained((carry, plant), cmd)        # warm-up and capture, not counted
    chain(plan, carry, plant, cmd, 2)   # eager warm-up, not counted
    reset_launch_counts()
    total_ms, ((c, p), _) = cuda_timed(
        lambda: chained((carry, plant), cmd))
    main_launches = LC.launches
    step_ms = total_ms / MAIN_CHAIN
    if launch_counts() != {'launches': MAIN_CHAIN,
                           'legs_launches': MAIN_CHAIN}:
        raise RuntimeError(f'main path launched {launch_counts()}, expected '
                           f'{MAIN_CHAIN} of the warp kernel and of the leg '
                           f'data and nothing else')
    eager_ms, (c_e, p_e, wrench, motor) = cuda_timed(
        lambda: chain(plan, carry, plant, cmd, MAIN_CHAIN))
    eager_step_ms = eager_ms / MAIN_CHAIN
    for name, x in (('wrench', wrench), ('tau', motor.tau),
                    ('f_ff', c.planner.f_ff), ('position', p.position)):
        if not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'main path output {name} not finite')
    if not tree_equal((c, p), (c_e, p_e)):
        raise RuntimeError('main path: the graphed chain is not bit for bit '
                           'the eager chain')
    main_solves_per_s = MAIN_BATCH / step_ms * 1e3
    emit(dict(phase='main', batch=MAIN_BATCH, chain=MAIN_CHAIN,
              launches=main_launches, ms_per_step=step_ms,
              eager_ms_per_step=eager_step_ms,
              graph_over_eager=eager_step_ms / step_ms,
              capture_seconds=capture_seconds(chained),
              warp_kernel_share_of_step=kernel_ms / step_ms,
              solves_per_s=main_solves_per_s, card=card))

    # ---- the headline benchmark, python -m hector_torch bench ----
    bench_phase(card, main_solves_per_s)

    # ---- the fused kernel's StageQPData entry on the main path's states ----
    max_err = max(max_err, stage_entry_phase(main_state, card))

    # ---- tier-1 closed loop ----
    half = LOOP_BATCH // 2
    plant = srb.init_plant_state(LOOP_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.concat(RT.walking_command(half, vx=0.5, device=dev),
                    RT.standing_command(LOOP_BATCH - half, device=dev))
    roll = RT.make_rollout(LOOP_PERIODS, CFG)
    torch.cuda.synchronize()
    LC.launches = LC.plant_launches = LC.legs_launches = 0
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = LC.launches
    loop_plant_launches = LC.plant_launches
    loop_legs_launches = LC.legs_launches
    h = diags['height'].cpu().numpy()
    vx = diags['vx'].cpu().numpy()
    fallen = int(diags['fallen'].sum())
    quarantined = int(diags['quarantined'].sum())
    res = dict(
        phase='loop', batch=LOOP_BATCH, periods=LOOP_PERIODS,
        launches=loop_launches, plant_launches=loop_plant_launches,
        legs_launches=loop_legs_launches, seconds=loop_s,
        sim_s_per_wall_s=LOOP_PERIODS * 5 * CFG.plant.dt / loop_s,
        capture_seconds=capture_seconds(roll.graphed),
        fallen_lane_periods=fallen, quarantined_lane_periods=quarantined,
        walk_min_height=float(h[:half].min()),
        walk_vx_last50=float(vx[:half, -50:].mean()),
        walk_x_final=float(plant.position[:half, 0].mean()),
        stand_height_last50=[float(h[half:, -50:].min()),
                             float(h[half:, -50:].max())],
        stand_vx_final=float(plant.v_world[half:, 0].abs().max()),
        card=card)
    emit(res)
    ticks = LOOP_PERIODS * CFG.mpc.mpc_cadence
    if (loop_launches, loop_plant_launches, loop_legs_launches) != (
            LOOP_PERIODS, ticks, ticks):
        raise RuntimeError(f'closed loop launched the kernel {loop_launches} '
                           f'times, the plant kernel {loop_plant_launches} '
                           f'and the leg data {loop_legs_launches}, expected '
                           f'{LOOP_PERIODS}, {ticks} and {ticks}')
    plant_entry['launches'] = loop_plant_launches
    legs_entry['launches'] = loop_legs_launches
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

    # ---- robustness: pushes, gait and mode schedules, FSM re-entry ----
    robust_phase(card, dev)

    # ---- the noisy estimators on the tier-1 loop, and the tier-2 plant ----
    estimators_phase(card, dev)
    whole_body_phase(card, dev)

    # ---- every captured path against its eager run; a trace of replays ----
    graph_phase(card, dev, Path(__file__).resolve().parent / 'hector_torch'
                / '_build' / 'chip_smoke_graph')

    # ---- Cholesky kernels vs plain versions on the path's KKT matrices ----
    dense_scfg = dataclasses.replace(scfg, backend='auto')
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    factor_err = solve_err = 0.0
    for batch, seed in ((DENSE_BATCH, 5), (RAGGED_BATCH, 6)):
        qp = scenario_problem(batch, seed, dev, M.build_dense)
        # what the interior point hands the wrappers: the first factor call
        # has D = 0, the last one is iteration 5's
        seen_m, seen_rhs = kkt_matrices(
            qp, dataclasses.replace(dense_scfg, iterations=6))
        for where, m, rhs in (('start', seen_m[0], seen_rhs[0]),
                              ('iteration 5', seen_m[-1], seen_rhs[-1])):
            l_k = CH.cholesky_bnn(m)
            l_s = CH.factor_shared_cuda(m, torch.empty_like(m))
            l_c = CH.factor_cluster_cuda(m, torch.empty_like(m))
            x_k = CH.cholesky_solve_bnn(l_k, rhs)
            x_s = CH.solve_shared_cuda(l_k, rhs, torch.empty_like(rhs))
            x_p = CH.cholesky_solve_nnb_plain(l_k.permute(1, 2, 0),
                                              rhs.t()).t()
            # the public batch-minor functions are views of the same kernels
            m_nnb = m.permute(1, 2, 0).contiguous()
            l_nnb = CH.cholesky_nnb(m_nnb)
            x_nnb = CH.cholesky_solve_nnb(l_nnb, rhs.t().contiguous())
            torch.cuda.synchronize()
            all_finite(l_k=l_k, x_k=x_k)
            d_l, l_scale, d_l_lane = factor_vs_plain(l_k, m)
            upper_nonzero = int((l_k * ~lower).count_nonzero())
            tile_equals_shared = bit_equal(l_k, l_s)
            cluster_equals_tile = bit_equal(l_c, l_k)
            edge = edge_rhs(rhs)
            solve_tile_equals_shared = (
                bit_equal(x_k, x_s)
                and bit_equal(CH.cholesky_solve_bnn(l_k, edge),
                              CH.solve_shared_cuda(l_k, edge,
                                                   torch.empty_like(edge))))
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
                      rel_dl=d_l / l_scale, rel_dl_worst_lane=d_l_lane,
                      rel_dl_tol=CHOL_FACTOR_TOL,
                      tile_equals_shared_kernel=tile_equals_shared,
                      cluster_kernel_equals_tile=cluster_equals_tile,
                      solve_tile_equals_shared_kernel=solve_tile_equals_shared,
                      upper_nonzero=upper_nonzero,
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
            if not d_l_lane <= CHOL_FACTOR_TOL:
                raise RuntimeError(f'factor kernel vs plain: {d_l_lane} of a '
                                   f'lane\'s max |L| > {CHOL_FACTOR_TOL}')
            if upper_nonzero:
                raise RuntimeError('factor kernel left non-zeros above the '
                                   'diagonal')
            if not tile_equals_shared:
                raise RuntimeError('the register-tile and shared-memory '
                                   'factor kernels disagree')
            if not cluster_equals_tile:
                raise RuntimeError('the cluster and register-tile factor '
                                   'kernels disagree at n = 120')
            if not solve_tile_equals_shared:
                raise RuntimeError('the register-tile and shared-memory '
                                   'solve kernels disagree (KKT or edge '
                                   'right-hand sides)')
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
    del seen_m, seen_rhs, l64, x64, r64, resid, x_true, x_s, edge, l_c
    del m_bad, l_bad, sol_ok, sol_bad

    # ---- the factor and the solve on random SPD matrices, both sides of
    # the route ----
    cluster_err = shared_err = stream_err = solve_shared_err = 0.0
    for size in SPD_SIZES:
        gen = torch.Generator(device=dev).manual_seed(size)
        x = torch.randn((SPD_BATCH, size, size), generator=gen, device=dev)
        m = x @ x.transpose(1, 2) / size + 1e-3 * torch.eye(size, device=dev)
        # what lies above the diagonal must not be read
        m = m + 1e3 * torch.triu(torch.randn((SPD_BATCH, size, size),
                                             generator=gen, device=dev), 1)
        l_k = CH.cholesky_bnn(m)
        l_s = CH.factor_shared_cuda(m, torch.empty_like(m))
        l_nnb = CH.cholesky_nnb(m.permute(1, 2, 0).contiguous())
        torch.cuda.synchronize()
        d_l, l_scale, d_l_lane = factor_vs_plain(l_k, m)
        low = torch.tril(torch.ones((size, size), dtype=torch.bool,
                                    device=dev))
        upper_nonzero = int((l_k * ~low).count_nonzero())
        kernel = CH.route(size)
        # the solve on these factors, with junk above their diagonals that
        # it must not read: the route's kernel against the shared-memory
        # solve bit for bit (and on edge right-hand sides), the streaming
        # solve launched at any n against the route's kernel, and against
        # the plain version lane by lane
        rhs = torch.randn((SPD_BATCH, size), generator=gen, device=dev)
        l_junk = l_k + 1e3 * torch.triu(torch.randn(
            (SPD_BATCH, size, size), generator=gen, device=dev), 1)
        edge = edge_rhs(rhs)
        x_k = CH.cholesky_solve_bnn(l_junk, rhs)
        x_s = CH.solve_shared_cuda(l_k, rhs, torch.empty_like(rhs))
        x_m = CH.solve_stream_cuda(l_junk, rhs, torch.empty_like(rhs))
        x_p = CH.cholesky_solve_nnb_plain(l_k.permute(1, 2, 0), rhs.t()).t()
        solve_kernel = CH.route(size, 'solve')
        solve_equal = (
            bit_equal(x_k, x_s) and bit_equal(x_m, x_k)
            and bit_equal(CH.cholesky_solve_bnn(l_junk, edge),
                          CH.solve_shared_cuda(l_k, edge,
                                               torch.empty_like(edge))))
        all_finite(spd_x=x_k)
        d_x = float((x_k - x_p).abs().max())
        d_x_lane = float(((x_k - x_p).abs().amax(1)
                          / x_p.abs().amax(1).clamp(min=1e-30)).max())
        rec = dict(phase='chol_spd', batch=SPD_BATCH, n=size, kernel=kernel,
                   max_abs_dl=d_l, l_scale=l_scale, rel_dl_worst_lane=d_l_lane,
                   upper_nonzero=upper_nonzero,
                   kernel_equals_shared_kernel=bit_equal(l_k, l_s),
                   nnb_views_equal=bool(torch.equal(l_nnb.permute(2, 0, 1),
                                                    l_k)),
                   solve_kernel=solve_kernel, solve_max_abs_dx=d_x,
                   solve_rel_dx_worst_lane=d_x_lane,
                   solve_equals_shared_and_stream_kernels=solve_equal)
        emit(rec)
        if kernel != ('factor_tile' if size <= TILE_MAX_N
                      else 'factor_cluster'):
            raise RuntimeError(f'n = {size} goes to {kernel}')
        if solve_kernel != ('solve_tile' if size <= TILE_MAX_N
                            else 'solve_stream'):
            raise RuntimeError(f'the solve at n = {size} goes to '
                               f'{solve_kernel}')
        if not (d_l_lane <= CHOL_FACTOR_TOL and upper_nonzero == 0
                and rec['kernel_equals_shared_kernel']
                and rec['nnb_views_equal']):
            raise RuntimeError(f'factor kernel at n = {size}: {rec}')
        if not (solve_equal and d_x_lane <= CHOL_SOLVE_VS_PLAIN_TOL_SPD):
            raise RuntimeError(f'solve kernel at n = {size}: {rec}')
        solve_shared_err = max(solve_shared_err, d_x)
        if solve_kernel == 'solve_stream':
            stream_err = max(stream_err, d_x)
        # bit for bit the routed kernel, so its error
        shared_err = max(shared_err, d_l)
        if kernel == 'factor_tile':
            factor_err = max(factor_err, d_l)
        else:
            cluster_err = max(cluster_err, d_l)
    del x, m, l_k, l_s, l_nnb, rhs, l_junk, edge, x_k, x_s, x_m, x_p

    # ---- the kernels timed: the two factor kernels in turns ----
    m_nnb = m_time.permute(1, 2, 0).contiguous()
    l_nnb = l_time.permute(1, 2, 0).contiguous()
    rhs_nb = rhs_time.t().contiguous()
    turns = {'tile': [], 'shared': []}
    for name in ('tile', 'shared', 'shared', 'tile'):
        fn = (CH.cholesky_bnn if name == 'tile' else
              lambda mm: CH.factor_shared_cuda(mm, torch.empty_like(mm)))
        turns[name].append(cuda_ms(lambda: fn(m_time), 20))
    factor_ms = sum(turns['tile']) / 2
    factor_shared_ms = sum(turns['shared']) / 2
    rhs_col = rhs_time[..., None].contiguous()
    s_turns = {'tile': [], 'shared': [], 'library': []}
    s_fns = {'tile': (lambda: CH.cholesky_solve_bnn(l_time, rhs_time), 20),
             'shared': (lambda: CH.solve_shared_cuda(
                 l_time, rhs_time, torch.empty_like(rhs_time)), 20),
             'library': (lambda: torch.cholesky_solve(rhs_col, l_time), 10)}
    for name in ('tile', 'shared', 'library', 'library', 'shared', 'tile'):
        s_turns[name].append(cuda_ms(*s_fns[name]))
    solve_ms, solve_shared_ms, solve_lib_ms = (
        sum(s_turns[k]) / 2 for k in ('tile', 'shared', 'library'))
    factor_nnb_ms = cuda_ms(lambda: CH.cholesky_nnb(m_nnb), 5)
    solve_nnb_ms = cuda_ms(lambda: CH.cholesky_solve_nnb(l_nnb, rhs_nb), 5)
    factor_plain_ms = cuda_ms(lambda: CH.cholesky_nnb_plain(m_nnb), 2)
    solve_plain_ms = cuda_ms(
        lambda: CH.cholesky_solve_nnb_plain(l_nnb, rhs_nb), 2)
    factor_lib_ms = cuda_ms(lambda: torch.linalg.cholesky(m_time), 10)
    f_ops, s_ops = CH.factor_op_count(n), CH.solve_op_count(n)
    f_bound = bound_ms(DENSE_BATCH * CH.factor_bytes(n),
                       DENSE_BATCH * sum(f_ops.values()))
    s_bound = bound_ms(DENSE_BATCH * CH.solve_bytes(n),
                       DENSE_BATCH * sum(s_ops.values()))
    tile_attr, solve_attr = attrs['chol_factor'], attrs['chol_solve']
    emit(dict(phase='chol_time', batch=DENSE_BATCH, n=n,
              factor=dict(ms=factor_ms, ms_turns=turns['tile'],
                          nnb_view_ms=factor_nnb_ms,
                          shared_kernel_ms=factor_shared_ms,
                          shared_kernel_ms_turns=turns['shared'],
                          plain_ms=factor_plain_ms, library_ms=factor_lib_ms,
                          bound_ms=f_bound[0], bound_by=f_bound[1],
                          ops_ms=f_bound[2], bytes_ms=f_bound[3],
                          share_of_bound=f_bound[0] / factor_ms,
                          registers=tile_attr['registers'],
                          threads_per_block=tile_attr['threads_per_block'],
                          blocks_per_sm=tile_attr['blocks_per_sm'],
                          shared_kernel_blocks_per_sm=CH.kernel_attributes(
                              n, 'factor_shared')['blocks_per_sm']),
              solve=dict(ms=solve_ms, ms_turns=s_turns['tile'],
                         nnb_view_ms=solve_nnb_ms,
                         shared_kernel_ms=solve_shared_ms,
                         shared_kernel_ms_turns=s_turns['shared'],
                         plain_ms=solve_plain_ms, library_ms=solve_lib_ms,
                         library_ms_turns=s_turns['library'],
                         bound_ms=s_bound[0], bound_by=s_bound[1],
                         ops_ms=s_bound[2], bytes_ms=s_bound[3],
                         share_of_bound=s_bound[0] / solve_ms,
                         registers=solve_attr['registers'],
                         threads_per_block=solve_attr['threads_per_block'],
                         blocks_per_sm=solve_attr['blocks_per_sm'],
                         shared_kernel_blocks_per_sm=CH.kernel_attributes(
                             n, 'solve_shared')['blocks_per_sm']),
              card=card))
    del m_nnb, l_nnb, m_time, l_time, rhs_col

    # ---- dense path: chained planning steps through the two kernels,
    # captured (bench.make_chain) and eager ----
    carry, plant, cmd = scenarios(DENSE_BATCH, 7, dev)
    plan_dense = RT.plan_step_fn(with_solver(CFG, backend='dense_auto'))
    chained_dense = bench.make_chain(plan_dense, DENSE_CHAIN).steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    chained_dense((carry, plant), cmd)  # warm-up and capture, not counted
    torch.cuda.synchronize()
    dense_peak = torch.cuda.max_memory_allocated() - held
    chain(plan_dense, carry, plant, cmd, 1)         # warm-up, not counted
    reset_launch_counts()
    total_ms, ((c, p), _) = cuda_timed(
        lambda: chained_dense((carry, plant), cmd))
    dense_launches = launch_counts()
    dense_factor_launches = LC.factor_launches
    dense_solve_launches = LC.solve_launches
    dense_step_ms = total_ms / DENSE_CHAIN
    reset_launch_counts()
    w_dense = []
    eager_ms, (c_e, p_e, wrench, motor) = cuda_timed(
        lambda: chain(plan_dense, carry, plant, cmd, DENSE_CHAIN, w_dense))
    dense_eager_launches = launch_counts()
    dense_eager_step_ms = eager_ms / DENSE_CHAIN
    want = {'factor_launches': DENSE_CHAIN * (scfg.iterations + 1),
            'solve_launches': DENSE_CHAIN * (2 * scfg.iterations + 1),
            'legs_launches': DENSE_CHAIN}
    if dense_launches != want or dense_eager_launches != want:
        raise RuntimeError(
            f'dense path launched {dense_launches} captured and '
            f'{dense_eager_launches} eager, expected {want} (the kernels '
            f'for a larger n and the Riccati kernels not at all)')
    if not tree_equal((c, p), (c_e, p_e)):
        raise RuntimeError('dense path: the captured chain is not bit for '
                           'bit the eager chain')
    all_finite(dense_wrench=torch.stack(w_dense), dense_tau=motor.tau,
               dense_f_ff=c.planner.f_ff, dense_position=p.position)
    # the same states through the plain versions and through the fused
    # Riccati solver (no launches of the Cholesky kernels in either)
    w_interp, w_riccati = [], []
    chain(RT.plan_step_fn(with_solver(CFG, backend='pallas_interpret')),
          carry, plant, cmd, DENSE_CHAIN, w_interp)
    chain(plan, carry, plant, cmd, DENSE_CHAIN, w_riccati)
    torch.cuda.synchronize()
    if (LC.factor_launches, LC.solve_launches) != (want['factor_launches'],
                                                   want['solve_launches']):
        raise RuntimeError('the comparison runs launched Cholesky kernels')
    d_interp = float((torch.stack(w_dense) - torch.stack(w_interp)).abs().max())
    d_riccati = float((torch.stack(w_dense)
                       - torch.stack(w_riccati)).abs().max())
    kernels_ms = ((scfg.iterations + 1) * factor_ms
                  + (2 * scfg.iterations + 1) * solve_ms)
    emit(dict(phase='dense', batch=DENSE_BATCH, chain=DENSE_CHAIN,
              launches=dense_launches, eager_launches=dense_eager_launches,
              ms_per_step=dense_step_ms,
              eager_ms_per_step=dense_eager_step_ms,
              graph_over_eager=dense_eager_step_ms / dense_step_ms,
              capture_seconds=capture_seconds(chained_dense),
              graph_nodes=graph_nodes(chained_dense)[0],
              capture_peak_bytes=dense_peak,
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

    del chained_dense

    # ---- dense closed loop, one captured period replayed a period ----
    half = DENSE_LOOP_BATCH // 2
    plant = srb.init_plant_state(DENSE_LOOP_BATCH, CFG, device=dev)
    carry = RT.init_controller_carry(plant, CFG)
    cmd = RT.concat(RT.walking_command(half, vx=0.5, device=dev),
                    RT.standing_command(DENSE_LOOP_BATCH - half, device=dev))
    roll = RT.make_rollout(DENSE_LOOP_PERIODS,
                           with_solver(CFG, backend='dense_auto'))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    carry, plant, diags = roll(carry, plant, cmd)
    torch.cuda.synchronize()
    dense_loop_s = time.perf_counter() - t0
    dense_loop_launches = launch_counts()
    fallen = int(diags['fallen'].sum())
    quarantined = int(diags['quarantined'].sum())
    h = diags['height'].cpu().numpy()
    emit(dict(phase='dense_loop', batch=DENSE_LOOP_BATCH,
              periods=DENSE_LOOP_PERIODS, launches=dense_loop_launches,
              captures=len(roll.graphed.captures),
              capture_seconds=capture_seconds(roll.graphed),
              seconds=dense_loop_s,
              sim_s_per_wall_s=(DENSE_LOOP_PERIODS * CFG.mpc.mpc_cadence
                                * CFG.plant.dt / dense_loop_s),
              fallen_lane_periods=fallen,
              quarantined_lane_periods=quarantined,
              min_height=float(h.min()),
              max_qp_mu=float(diags['qp_mu'].max()),
              walk_x_final=float(plant.position[:half, 0].mean()),
              card=card))
    want = {'factor_launches': DENSE_LOOP_PERIODS * (scfg.iterations + 1),
            'solve_launches': DENSE_LOOP_PERIODS * (2 * scfg.iterations + 1),
            'plant_launches': DENSE_LOOP_PERIODS * CFG.mpc.mpc_cadence,
            'legs_launches': DENSE_LOOP_PERIODS * CFG.mpc.mpc_cadence}
    if dense_loop_launches != want:
        raise RuntimeError(f'dense loop launched {dense_loop_launches}, '
                           f'expected {want}')
    if len(roll.graphed.captures) != 1:
        raise RuntimeError('dense loop: the period was not captured once')
    if fallen or quarantined:
        raise RuntimeError('dense loop: lanes fell or were quarantined')
    all_finite(dense_loop_height=diags['height'],
               dense_loop_position=plant.position)
    if not h.min() > 0.4:
        raise RuntimeError('dense loop: a lane collapsed')
    del roll

    # ---- dense path at a long horizon: the cluster factor, the streaming
    # solve ----
    def wrench_diff(a, b):
        return float((a.u[:, :12].double() - b.u[:, :12].double()).abs().max())

    long_cfg = dataclasses.replace(
        with_solver(CFG, backend='dense_auto'),
        mpc=dataclasses.replace(CFG.mpc, horizon=LONG_HORIZON))
    qp_long = scenario_problem(LONG_BATCH, 10, dev, M.build_dense, long_cfg)
    # the batch solve's compiled entry (JAX's make_solver), captured at its
    # first call, beside the eager mpc.solve
    solver_long = PD.make_solver(dataclasses.replace(long_cfg.solver,
                                                     backend='auto'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    solver_long(qp_long)                # warm-up and capture, not counted
    torch.cuda.synchronize()
    long_peak = torch.cuda.max_memory_allocated() - held
    M.solve(qp_long, long_cfg)                      # warm-up, not counted
    # LONG_SOLVES of each in turns (captured, eager, eager, captured, ...);
    # the first of each counted, the median reported
    long_ms_turns, long_eager_ms_turns = [], []
    long_launches = long_eager_launches = None
    for k in range(2 * LONG_SOLVES):
        eager = k % 4 in (1, 2)
        reset_launch_counts()
        ms, sol = cuda_timed(
            (lambda: M.solve(qp_long, long_cfg)) if eager
            else (lambda: solver_long(qp_long)))
        if eager:
            long_eager_ms_turns.append(ms)
            long_eager_launches = long_eager_launches or launch_counts()
            sol_long_eager = sol
        else:
            long_ms_turns.append(ms)
            long_launches = long_launches or launch_counts()
            sol_long = sol
    long_step_ms = sorted(long_ms_turns)[LONG_SOLVES // 2]
    long_eager_step_ms = sorted(long_eager_ms_turns)[LONG_SOLVES // 2]
    it = scfg.iterations
    want = dict(factor_launches=it + 1, factor_cluster_launches=it + 1,
                solve_launches=2 * it + 1, solve_stream_launches=2 * it + 1)
    if long_launches != want or long_eager_launches != want:
        raise RuntimeError(f'long-horizon dense solve launched '
                           f'{long_launches} captured and '
                           f'{long_eager_launches} eager, expected {want}')
    if not tree_equal(sol_long, sol_long_eager):
        raise RuntimeError('long-horizon dense solve: the captured solve is '
                           'not bit for bit mpc.solve')
    long_captures = len(solver_long.steps.captures)
    long_nodes = graph_nodes(solver_long.steps)[0]
    long_capture_s = capture_seconds(solver_long.steps)
    del solver_long, sol_long_eager
    sol_long_int = M.solve(qp_long, with_solver(long_cfg,
                                                backend='pallas_interpret'))
    # the same QPs in float64 (torch.linalg): the answer both float32 runs
    # are held to
    qp_long64 = type(qp_long)(*[x.double() for x in qp_long])
    sol_long64 = M.solve(qp_long64, with_solver(long_cfg, backend='xla'))
    all_finite(long_u=sol_long.u, long_u64=sol_long64.u)
    d_long = wrench_diff(sol_long, sol_long_int)
    d_long_f64 = wrench_diff(sol_long, sol_long64)
    d_int_f64 = wrench_diff(sol_long_int, sol_long64)
    del sol_long, sol_long_int, qp_long64, sol_long64
    # the factor and the solve against their plain versions on the path's
    # KKT matrices
    seen_m, seen_rhs = kkt_matrices(qp_long, dataclasses.replace(
        long_cfg.solver, backend='auto', iterations=6))
    cluster_lane_err = long_solve_err = 0.0
    long_solve_lane = {}
    cluster_equals_shared = {}
    stream_equals_shared = {}
    for where, m, rhs in (('start', seen_m[0], seen_rhs[0]),
                          ('iteration 5', seen_m[-1], seen_rhs[-1])):
        l_k = CH.cholesky_bnn(m)
        l_s = CH.factor_shared_cuda(m, torch.empty_like(m))
        x_k = CH.cholesky_solve_bnn(l_k, rhs)
        x_s = CH.solve_shared_cuda(l_k, rhs, torch.empty_like(rhs))
        edge = edge_rhs(rhs)
        stream_equals_shared[where] = (
            bit_equal(x_k, x_s)
            and bit_equal(CH.cholesky_solve_bnn(l_k, edge),
                          CH.solve_shared_cuda(l_k, edge,
                                               torch.empty_like(edge))))
        x_p = CH.cholesky_solve_nnb_plain(l_k.permute(1, 2, 0), rhs.t()).t()
        all_finite(long_x=x_k)
        d_l, _, d_l_lane = factor_vs_plain(l_k, m)
        cluster_equals_shared[where] = bit_equal(l_k, l_s)
        cluster_err = max(cluster_err, d_l)
        cluster_lane_err = max(cluster_lane_err, d_l_lane)
        long_solve_err = max(long_solve_err, float((x_k - x_p).abs().max()))
        long_solve_lane[where] = float(
            ((x_k - x_p).abs().amax(1)
             / x_p.abs().amax(1).clamp(min=1e-30)).max())
    m_long, rhs_long = seen_m[-1], seen_rhs[-1]
    del seen_m, seen_rhs, m, rhs, l_k, l_s, x_k, x_s, x_p, edge

    # timed on iteration 5's matrices: the route's cluster factor, the
    # shared-triangle factor and the library in turns, beside the plain
    # versions
    m_long_nnb = m_long.permute(1, 2, 0).contiguous()
    f_turns = {'cluster': [], 'shared': [], 'library': []}
    f_fns = {'cluster': (lambda: CH.cholesky_bnn(m_long), 10),
             'shared': (lambda: CH.factor_shared_cuda(
                 m_long, torch.empty_like(m_long)), 5),
             'library': (lambda: torch.linalg.cholesky(m_long), 5)}
    for name in ('cluster', 'shared', 'library', 'library', 'shared',
                 'cluster'):
        f_turns[name].append(cuda_ms(*f_fns[name]))
    long_factor_ms, long_shared_ms, long_lib_ms = (
        sum(f_turns[k]) / 2 for k in ('cluster', 'shared', 'library'))
    long_plain_ms = cuda_ms(lambda: CH.cholesky_nnb_plain(m_long_nnb), 1)
    long_bound = bound_ms(LONG_BATCH * CH.factor_bytes(n_long),
                          LONG_BATCH * sum(CH.factor_op_count(n_long).values()))
    l_long = CH.cholesky_bnn(m_long)
    l_long_nnb = l_long.permute(1, 2, 0).contiguous()
    rhs_long_nb = rhs_long.t().contiguous()
    rhs_long_col = rhs_long[..., None].contiguous()
    # the route's streaming solve, the shared-memory solve and the library
    # in turns
    s_turns = {'stream': [], 'shared': [], 'library': []}
    s_fns = {'stream': (lambda: CH.cholesky_solve_bnn(l_long, rhs_long), 20),
             'shared': (lambda: CH.solve_shared_cuda(
                 l_long, rhs_long, torch.empty_like(rhs_long)), 5),
             'library': (lambda: torch.cholesky_solve(rhs_long_col, l_long),
                         5)}
    for name in ('stream', 'shared', 'library', 'library', 'shared',
                 'stream'):
        s_turns[name].append(cuda_ms(*s_fns[name]))
    long_solve_ms, long_solve_shared_ms, long_solve_lib_ms = (
        sum(s_turns[k]) / 2 for k in ('stream', 'shared', 'library'))
    long_solve_plain_ms = cuda_ms(
        lambda: CH.cholesky_solve_nnb_plain(l_long_nnb, rhs_long_nb), 1)
    long_s_bound = bound_ms(LONG_BATCH * CH.solve_bytes(n_long),
                            LONG_BATCH * sum(CH.solve_op_count(n_long).values()))
    emit(dict(phase='dense_long', batch=LONG_BATCH, horizon=LONG_HORIZON,
              n=n_long, launches=long_launches,
              eager_launches=long_eager_launches, ms_per_solve=long_step_ms,
              ms_per_solve_turns=long_ms_turns,
              eager_ms_per_solve=long_eager_step_ms,
              eager_ms_per_solve_turns=long_eager_ms_turns,
              graph_over_eager=long_eager_step_ms / long_step_ms,
              captures=long_captures, capture_seconds=long_capture_s,
              graph_nodes=long_nodes, capture_peak_bytes=long_peak,
              max_abs_vs_pallas_interpret=d_long,
              max_abs_vs_f64=dict(kernels=d_long_f64,
                                  pallas_interpret=d_int_f64),
              factor_max_abs_dl=cluster_err,
              factor_rel_dl_worst_lane=cluster_lane_err,
              factor_cluster_equals_shared_kernel=cluster_equals_shared,
              solve_max_abs_dx=long_solve_err,
              solve_rel_dx_worst_lane=long_solve_lane,
              solve_stream_equals_shared_kernel=stream_equals_shared,
              factor=dict(ms=long_factor_ms, ms_turns=f_turns['cluster'],
                          shared_kernel_ms=long_shared_ms,
                          shared_kernel_ms_turns=f_turns['shared'],
                          plain_ms=long_plain_ms, library_ms=long_lib_ms,
                          library_ms_turns=f_turns['library'],
                          bound_ms=long_bound[0], bound_by=long_bound[1],
                          share_of_bound=long_bound[0] / long_factor_ms,
                          shared_kernel_share_of_bound=(long_bound[0]
                                                        / long_shared_ms),
                          attributes=attrs['chol_factor_cluster'],
                          shared_kernel_attributes=attrs[
                              'chol_factor_shared']),
              solve=dict(ms=long_solve_ms, ms_turns=s_turns['stream'],
                         shared_kernel_ms=long_solve_shared_ms,
                         shared_kernel_ms_turns=s_turns['shared'],
                         plain_ms=long_solve_plain_ms,
                         library_ms=long_solve_lib_ms,
                         library_ms_turns=s_turns['library'],
                         bound_ms=long_s_bound[0], bound_by=long_s_bound[1],
                         share_of_bound=long_s_bound[0] / long_solve_ms,
                         shared_kernel_share_of_bound=(long_s_bound[0]
                                                       / long_solve_shared_ms),
                         attributes=attrs['chol_solve_stream'],
                         shared_kernel_attributes=attrs[
                             'chol_solve_shared']),
              card=card))
    if not d_long_f64 <= d_int_f64 + DENSE_VS_INTERPRET_TOL:
        raise RuntimeError(f'long-horizon dense solve: {d_long_f64} N from '
                           f'the float64 solve, the plain versions '
                           f'{d_int_f64} N')
    if not cluster_lane_err <= CHOL_FACTOR_TOL:
        raise RuntimeError(f'cluster factor vs plain: {cluster_lane_err}'
                           f' of a lane\'s max |L| > {CHOL_FACTOR_TOL}')
    if not all(cluster_equals_shared.values()):
        raise RuntimeError(f'the cluster and shared-triangle factor kernels '
                           f'disagree on the long-horizon KKT matrices: '
                           f'{cluster_equals_shared}')
    shared_err = max(shared_err, cluster_err)     # bit for bit, so its error
    if not all(stream_equals_shared.values()):
        raise RuntimeError(f'the streaming and shared-memory solve kernels '
                           f'disagree on the long-horizon KKT matrices (or '
                           f'edge right-hand sides): {stream_equals_shared}')
    for where, v in long_solve_lane.items():
        if not v <= CHOL_SOLVE_VS_PLAIN_TOL_LONG:
            raise RuntimeError(f'streaming solve vs plain at n = '
                               f'{n_long} ({where}): {v} of a lane\'s |x| > '
                               f'{CHOL_SOLVE_VS_PLAIN_TOL_LONG}')
    # bit for bit the route's kernels, so their errors
    stream_err = max(stream_err, long_solve_err)
    solve_shared_err = max(solve_shared_err, long_solve_err)
    del m_long, m_long_nnb, l_long, l_long_nnb, rhs_long, rhs_long_nb
    del rhs_long_col, qp_long

    # ---- polish: the kernel with polish_rounds=8 vs its plain version ----
    polish_err = 0.0
    # at 4,096 and ragged 4,099 lanes, and on the QPs of the main path
    for batch, parts in ((4096, scenario_parts(4096, 8, dev)),
                         (RAGGED_BATCH, scenario_parts(RAGGED_BATCH, 9, dev)),
                         (MAIN_BATCH, main_parts)):
        polish_err = max(polish_err, hold_polish(
            (FR.solve_parts_cuda, parts, q_diag, r_diag),
            (FR.solve_parts_plain, parts, q_diag, r_diag), pcfg, 'polish'))

    polish_solves = [0]

    def polish_run():
        polish_solves[0] += 1
        return FR.solve_parts_cuda(main_parts, pcfg, q_diag, r_diag)

    # in turns, on the same QPs: with polish, without, without, with
    turns = {'polish': [], 'ip': []}
    steps0 = FR.polish_step_counts()
    for name, fn, reps in (('polish', polish_run, 3), ('ip', ip_run, 10),
                           ('ip', ip_run, 10), ('polish', polish_run, 3)):
        turns[name].append(cuda_ms(fn, reps))
    steps1 = FR.polish_step_counts()
    pol_steps = pcfg.polish_rounds * pcfg.polish_iters
    # the kernel's counts over the turns' solves: every lane's polish steps,
    # and at least polish_iters - 1 of each round's re-solved
    steps, resolved = steps1[0] - steps0[0], steps1[1] - steps0[1]
    lanes = polish_solves[0] * MAIN_BATCH
    if not (lanes and steps == lanes * pol_steps and resolved
            >= lanes * pcfg.polish_rounds * (pcfg.polish_iters - 1)):
        raise RuntimeError(f'polish: {steps} polish steps counted, '
                           f'{resolved} re-solved, over {polish_solves[0]} '
                           f'solves of {MAIN_BATCH} lanes x {pol_steps} steps')
    polish_ms = sum(turns['polish']) / 2
    kernel_ms_again = sum(turns['ip']) / 2
    polish_plain_ms = cuda_ms(
        lambda: FR.solve_parts_plain(main_parts, pcfg, q_diag, r_diag), 1)
    pops = FR.op_count(scfg.iterations, pol_steps)
    pol_bound = bound_ms(MAIN_BATCH * FR.bytes_per_scenario(),
                         MAIN_BATCH * sum(pops.values()))
    emit(dict(phase='polish_time', batch=MAIN_BATCH, polish_steps=pol_steps,
              resolved_share=resolved / steps,
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
    LC.launches = LC.polish_launches = 0
    LC.factor_launches = LC.solve_launches = 0
    total_ms, (c, p, wrench, motor) = cuda_timed(
        lambda: chain(plan_polish, carry, plant, cmd, POLISH_CHAIN))
    polish_path_launches = LC.polish_launches
    polish_step_ms = total_ms / POLISH_CHAIN
    if (polish_path_launches != POLISH_CHAIN or LC.launches
            or LC.factor_launches or LC.solve_launches):
        raise RuntimeError(
            f'polish path launched the kernel with polish '
            f'{polish_path_launches} times, without {LC.launches} times and '
            f'the Cholesky kernels {LC.factor_launches}/{LC.solve_launches} '
            f'times, expected {POLISH_CHAIN}, 0 and 0/0')
    all_finite(polish_wrench=wrench, polish_tau=motor.tau,
               polish_f_ff=c.planner.f_ff)
    emit(dict(phase='polish_path', batch=MAIN_BATCH, chain=POLISH_CHAIN,
              launches=polish_path_launches, ms_per_step=polish_step_ms,
              card=card))

    # ---- the entry points: the CLI, parallel, checkpoints, the stream ----
    build_dir = Path(__file__).resolve().parent / 'hector_torch' / '_build'
    cli_phase(card, dev, str(build_dir / 'chip_smoke_cli'))

    # ---- multihost over NCCL: a one-process group on this card ----
    multihost_phase(card, str(build_dir / 'chip_smoke_multihost'))

    emit({'kernels': [
        plant_entry,
        legs_entry,
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
        dict(name='chol_factor_cluster', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:48',
             launches=long_launches.get('factor_cluster_launches', 0),
             max_abs_err=cluster_err, ms=long_factor_ms,
             plain_ms=long_plain_ms, bound_ms=long_bound[0],
             bound_by=long_bound[1], library_ms=long_lib_ms),
        # the yardstick the cluster factor is held to, off the route
        dict(name='chol_factor_shared', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:48',
             launches=long_launches.get('factor_shared_launches', 0), max_abs_err=shared_err,
             ms=long_shared_ms, plain_ms=long_plain_ms,
             bound_ms=long_bound[0], bound_by=long_bound[1],
             library_ms=long_lib_ms),
        dict(name='chol_solve', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:77',
             launches=dense_solve_launches, max_abs_err=solve_err,
             ms=solve_ms, plain_ms=solve_plain_ms, bound_ms=s_bound[0],
             bound_by=s_bound[1], library_ms=solve_lib_ms),
        dict(name='chol_solve_stream', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:77',
             launches=long_launches.get('solve_stream_launches', 0),
             max_abs_err=stream_err, ms=long_solve_ms,
             plain_ms=long_solve_plain_ms, bound_ms=long_s_bound[0],
             bound_by=long_s_bound[1], library_ms=long_solve_lib_ms),
        # the yardstick the tile and streaming solves are held to, off the
        # route
        dict(name='chol_solve_shared', route='cuda',
             source='hector_torch/csrc/chol.cu',
             replaces='hector/qp/pallas_chol.py:77',
             launches=long_launches.get('solve_shared_launches', 0),
             max_abs_err=solve_shared_err, ms=long_solve_shared_ms,
             plain_ms=long_solve_plain_ms, bound_ms=long_s_bound[0],
             bound_by=long_s_bound[1], library_ms=long_solve_lib_ms)]})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
