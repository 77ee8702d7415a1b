"""Where the time of the warp kernel goes, on one NVIDIA GPU.

    python3 profile_warp_kernel.py [--source PATH]

Profiles the kernel without polish (fused_riccati_warp_kernel<false>, the
one the main path launches).  Builds hector_torch/csrc/fused_riccati_warp.cu
four ways: as the port runs it; with -DFR_PHASE_CLOCKS (clock64 marks
between the kernel's phases); and with -DFR_EXTRA_SMEM set so that an SM
holds 12 and 8 warps instead of 16.
Each build is held to the plain PyTorch version (chip_smoke.hold_to_plain)
on the 32,768 closed-loop QPs of chip_smoke.py's kernel phase, then all are
timed in turns (A B C D D C B A) with CUDA events.  Prints one JSON line per
build (ptxas report, attributes, times), the share of warp cycles in each
phase, the card's name and power limit, and {"ok": true, ...} last.

Then the kernel with polish (<true>, polish_rounds 8 x polish_iters 4) on
the same QPs: its time and its counts of polish steps and re-solves, and
the phase clocks of an interior-point iteration, of a polish step's full
sweep and of a re-solve on saved factors, each a share of its own mode's
cycles and in warp cycles a step and scenario.  ``--source PATH`` profiles
another copy of the source the same way; it must declare the same entry
points as hector_torch/csrc/fused_riccati_warp.cu.

How to read it: if the time grows with 1 / warps an SM when the SM holds
fewer, the kernel is latency-bound; if it does not move, issue-bound.  The
phase shares are of each warp's own cycles (a warp waiting on another's
issue counts), so they rank phases, they do not add up to device time.
In a polish step phase 9 ("step") is its update, multipliers and round end
included; in a re-solve "Cholesky" is the copy of the saved L back to
shared memory.
Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import torch

import chip_smoke as CS

BATCH = 32768
REPS = 10
POLISH_REPS = 3
# per block: 2 x 13,968 B static + 148 B + 1 KB reserved; these leave room
# for 6 and 4 blocks of 2 warps on an SM's 228 KB
EXTRA_SMEM = {12: 9000, 8: 25000}
PHASES = ('rollout', 'P A and B^T P', 'Re', 'Cholesky', 'G and beta',
          'forward substitution', 'P update, p, back substitution',
          'forward rollout', 'iteration set-up', 'step', 'final residuals')
MODES = ('interior point', 'polish step, full sweep', 'polish step, re-solve')


def shares(cycles):
    total = sum(cycles)
    return {p: (c / total if total else 0.0) for p, c in zip(PHASES, cycles)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--source', default=None,
                    help='another copy of fused_riccati_warp.cu to profile')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('profile_warp_kernel: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import cuda
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.qp import fused_riccati as FR

    FUSED = cuda.FUSED
    lib_src = FUSED
    if args.source:
        lib_src = cuda.Library(Path(args.source).resolve(), FUSED.flags,
                               FUSED.error_string, FUSED.entries)
    card = CS.card_line()
    dev = torch.device('cuda')
    scfg = CFG.solver
    pcfg = dataclasses.replace(scfg, polish_rounds=CS.POLISH_ROUNDS)
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)
    builds = {'production': ()}
    builds['phase clocks'] = ('-DFR_PHASE_CLOCKS',)
    for warps, extra in EXTRA_SMEM.items():
        builds[f'{warps} warps an SM'] = (f'-DFR_EXTRA_SMEM={extra}',)
    libs = {name: lib_src.variant(d) for name, d in builds.items()}
    FUSED.handle = libs['production'][0]   # the scenarios' rollouts launch it
    parts = CS.scenario_parts(BATCH, 3, dev)

    def run():
        return FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)

    def run_polish():
        return FR.solve_parts_cuda(parts, pcfg, q_diag, r_diag)

    recs = {}
    for name, (lib, info) in libs.items():
        FUSED.handle = lib
        CS.hold_to_plain(FR, parts, scfg, q_diag, r_diag)
        run()
        torch.cuda.synchronize()
        recs[name] = dict(
            build=name, source=str(lib_src.source), defines=builds[name],
            ptxas=CS.parse_ptxas(info['ptxas']).get('fused_riccati'),
            attributes=FR.kernel_attributes('warp'), ms_turns=[])
    order = list(libs) + list(libs)[::-1]
    for name in order:
        FUSED.handle = libs[name][0]
        recs[name]['ms_turns'].append(CS.cuda_ms(run, REPS))
    for rec in recs.values():
        rec['ms'] = sum(rec['ms_turns']) / len(rec['ms_turns'])
        rec['card'] = card
        CS.emit(rec)

    clocks = libs['phase clocks'][0]
    read = clocks.fused_riccati_warp_phase_cycles
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    n_read = len(PHASES) * len(MODES)

    def phase_cycles(fn):
        cycles = (ctypes.c_ulonglong * n_read)()
        read(cycles)                   # zero what earlier runs left
        fn()
        torch.cuda.synchronize()
        rc = read(cycles)
        if rc != 0:
            raise RuntimeError(f'reading the phase clocks failed: {rc}')
        return list(cycles)

    FUSED.handle = clocks
    cycles = phase_cycles(run)[:len(PHASES)]
    CS.emit(dict(phase='phases', batch=BATCH, share=shares(cycles),
                 warp_cycles_per_scenario=sum(cycles) / BATCH, card=card))

    # ---- the kernel with polish ----
    FUSED.handle = libs['production'][0]
    n_pol = pcfg.polish_rounds * pcfg.polish_iters
    steps0 = FR.polish_step_counts()
    polish_ms = CS.cuda_ms(run_polish, POLISH_REPS)
    steps1 = FR.polish_step_counts()
    steps, resolved = steps1[0] - steps0[0], steps1[1] - steps0[1]
    CS.emit(dict(phase='polish_time', source=str(lib_src.source),
                 batch=BATCH, polish_steps=n_pol, ms=polish_ms,
                 resolved_share=resolved / steps if steps else None,
                 ptxas=CS.parse_ptxas(libs['production'][1]['ptxas']).get(
                     'fused_riccati_polish'),
                 attributes=FR.kernel_attributes('polish'), card=card))
    FUSED.handle = clocks
    steps0 = FR.polish_step_counts()
    cycles = phase_cycles(run_polish)
    steps1 = FR.polish_step_counts()
    steps, resolved = steps1[0] - steps0[0], steps1[1] - steps0[1]
    per_mode = [cycles[m * len(PHASES):(m + 1) * len(PHASES)]
                for m in range(len(MODES))]
    counts = (None, steps - resolved, resolved)
    for mode, cyc, n in zip(MODES, per_mode, counts):
        CS.emit(dict(phase='polish phases', source=str(lib_src.source),
                     mode=mode, batch=BATCH, steps=n, share=shares(cyc),
                     warp_cycles=sum(cyc),
                     warp_cycles_per_step_and_scenario=(
                         sum(cyc) / n if n else None),
                     card=card))
    print(card, flush=True)
    CS.emit({'ok': True, 'device': {'platform': 'gpu',
                                    'kind': torch.cuda.get_device_name(0),
                                    'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
