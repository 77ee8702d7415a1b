"""Where the time of the register-tile Cholesky factor goes, on one NVIDIA GPU.

    python3 profile_chol_kernel.py

Profiles chol_factor_kernel (hector_torch/csrc/chol.cu) on the KKT matrices
of chip_smoke.py's chol phase (4,096 closed-loop lanes, n = 120, iteration
5 of the dense interior point).  Builds the source four ways: as the port
runs it; with -DCHOL_PHASE_CLOCKS (clock64 marks of the block's last warp,
the one that stays in the panel loop to the end); and with
-DCHOL_EXTRA_SMEM set so that an SM holds 2 and 1 blocks instead of 4.
Each build is held to the shared-memory factor kernel bit for bit, then
the production build and the two capped ones are timed in turns (A B C C B
A) with CUDA events, and the production build at 132 and 528 lanes (one
block an SM; one full wave).  Prints one JSON line per build, the phase
shares, the card's name and power limit, and {"ok": true, ...} last.

How to read it: if the time grows as 1 / blocks an SM when the SM holds
fewer, the blocks' own chains (latency) bound the kernel; if it does not
move, the schedulers' instruction rate does.  The phase shares are of the
last warp's own cycles; the compiler moves arithmetic across the marks,
so they rank phases roughly.  Needs one CUDA device; imports nothing of
JAX or of hector/.
"""

import ctypes
import dataclasses
import sys

import torch

import chip_smoke as CS

BATCH = 4096
REPS = 20
# the tile kernel's block: 8,224 B static shared memory and 1 KB reserved;
# with these unused dynamic bytes 2 and 1 of them fit an SM's 228 KB
EXTRA_SMEM = {'2 blocks an SM': 70000, '1 block an SM': 110000}
PHASES = ('load', 'diagonal factor', 'waiting for the diagonal tile',
          'column solve', 'waiting for the panel', 'trailing update',
          'store')


def main():
    if not torch.cuda.is_available():
        print('profile_chol_kernel: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import mpc as M
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.qp import chol as CH

    card = CS.card_line()
    dev = torch.device('cuda')
    production = CH.build()
    builds = {'production': (production, CH.build_info)}
    builds['phase clocks'] = CH.kernel_variant(('-DCHOL_PHASE_CLOCKS',))
    for name, extra in EXTRA_SMEM.items():
        builds[name] = CH.kernel_variant((f'-DCHOL_EXTRA_SMEM={extra}',))
    qp = CS.scenario_problem(BATCH, 5, dev, M.build_dense)
    seen_m, _ = CS.kkt_matrices(qp, dataclasses.replace(
        CFG.solver, backend='auto', iterations=6))
    m = seen_m[-1]
    n = m.shape[1]
    ref = CH.factor_shared_cuda(m, torch.empty_like(m))

    def run(lib, mm):
        CH._lib = lib
        try:
            return CH.cholesky_bnn(mm)
        finally:
            CH._lib = production

    times = {}
    for name, (lib, info) in builds.items():
        if not torch.equal(run(lib, m), ref):
            raise RuntimeError(f'{name}: the factor differs from the '
                               f'shared-memory kernel')
        CH._lib = lib
        attr = CH.kernel_attributes(n, 'tile')
        CH._lib = production
        used = [ln.strip() for ln in info.get('ptxas', '').splitlines()
                if 'chol_factor_kernel' in ln or 'Used' in ln]
        CS.emit(dict(build=name, attributes=attr, ptxas=used))
        times[name] = []
    timed = ['production', *EXTRA_SMEM]
    for name in timed + timed[::-1]:
        lib = builds[name][0]
        times[name].append(CS.cuda_ms(lambda: run(lib, m), REPS))
    by_batch = {b: CS.cuda_ms(lambda: run(production, m[:b]), REPS)
                for b in (132, 528, BATCH)}
    CS.emit(dict(batch=BATCH, n=n, ms_turns={k: times[k] for k in timed},
                 ms_by_batch=by_batch, card=card))

    clocks = builds['phase clocks'][0]
    clocks.chol_phase_cycles.argtypes = [ctypes.c_void_p]
    clocks.chol_phase_cycles.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    for b in (132, BATCH):
        run(clocks, m[:b])                       # warm-up
        torch.cuda.synchronize()
        if clocks.chol_phase_cycles(out) != 0:
            raise RuntimeError('chol_phase_cycles failed')
        run(clocks, m[:b])
        torch.cuda.synchronize()
        if clocks.chol_phase_cycles(out) != 0:
            raise RuntimeError('chol_phase_cycles failed')
        cyc, blocks = list(out[:len(PHASES)]), out[len(PHASES)]
        if blocks != b:
            raise RuntimeError(f'{blocks} blocks clocked, {b} launched')
        total = sum(cyc)
        CS.emit(dict(batch=b, cycles_per_block=total / blocks,
                     phase_cycles_per_block={
                         p: c / blocks for p, c in zip(PHASES, cyc)},
                     phase_share={p: c / total
                                  for p, c in zip(PHASES, cyc)}))
    print(card, flush=True)
    CS.emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
