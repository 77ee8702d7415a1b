"""Where the time of the warp kernel goes, on one NVIDIA GPU.

    python3 profile_warp_kernel.py

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

How to read it: if the time grows with 1 / warps an SM when the SM holds
fewer, the kernel is latency-bound; if it does not move, issue-bound.  The
phase shares are of each warp's own cycles (a warp waiting on another's
issue counts), so they rank phases, they do not add up to device time.
Needs one CUDA device; imports nothing of JAX or of hector/.
"""

import ctypes
import json
import sys

import torch

import chip_smoke as CS

BATCH = 32768
REPS = 10
# per block: 2 x 13,968 B static + 148 B + 1 KB reserved; these leave room
# for 6 and 4 blocks of 2 warps on an SM's 228 KB
EXTRA_SMEM = {12: 9000, 8: 25000}
PHASES = ('rollout', 'P A and B^T P', 'Re', 'Cholesky', 'G and beta',
          'forward substitution', 'P update, p, back substitution',
          'forward rollout', 'iteration set-up', 'step', 'final residuals')


def main():
    if not torch.cuda.is_available():
        print('profile_warp_kernel: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.cuda import FUSED
    from hector_torch.qp import fused_riccati as FR

    card = CS.card_line()
    dev = torch.device('cuda')
    scfg = CFG.solver
    q_diag = tuple(CFG.mpc.weights) + (0.0,)
    r_diag = tuple(CFG.mpc.alpha)
    builds = {'production': ()}
    builds['phase clocks'] = ('-DFR_PHASE_CLOCKS',)
    for warps, extra in EXTRA_SMEM.items():
        builds[f'{warps} warps an SM'] = (f'-DFR_EXTRA_SMEM={extra}',)
    libs = {name: FUSED.variant(d) for name, d in builds.items()}
    parts = CS.scenario_parts(BATCH, 3, dev)

    def run():
        return FR.solve_parts_cuda(parts, scfg, q_diag, r_diag)

    recs = {}
    for name, (lib, info) in libs.items():
        FUSED.handle = lib
        CS.hold_to_plain(FR, parts, scfg, q_diag, r_diag)
        run()
        torch.cuda.synchronize()
        recs[name] = dict(
            build=name, defines=builds[name],
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

    lib = FUSED.handle = libs['phase clocks'][0]
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    read = lib.fused_riccati_warp_phase_cycles
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read(cycles)                       # zero what the runs above left
    run()
    torch.cuda.synchronize()
    rc = read(cycles)
    if rc != 0:
        raise RuntimeError(f'reading the phase clocks failed: {rc}')
    total = sum(cycles)
    CS.emit(dict(phase='phases', batch=BATCH,
                 share={p: cycles[i] / total for i, p in enumerate(PHASES)},
                 warp_cycles_per_scenario=total / BATCH, card=card))
    print(card, flush=True)
    CS.emit({'ok': True, 'device': {'platform': 'gpu',
                                    'kind': torch.cuda.get_device_name(0),
                                    'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
