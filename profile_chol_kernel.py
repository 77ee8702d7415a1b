"""Where the time of the Cholesky tile, cluster and streaming kernels goes,
on one NVIDIA GPU.

    python3 profile_chol_kernel.py

Profiles chol_factor_kernel and chol_solve_kernel (hector_torch/csrc/chol.cu)
on the KKT matrices of chip_smoke.py's chol phase (4,096 closed-loop lanes,
n = 120, iteration 5 of the dense interior point).  Builds the source
eight ways, all at once: as the port runs it; with -DCHOL_PHASE_CLOCKS
(clock64 marks of the factor block's last warp, the one that stays in the
panel loop to the end); with -DCHOL_STEP_CLOCKS (the SM clock of each block
of the solve after each barrier: a timeline of its panels); and with
-DCHOL_EXTRA_SMEM set so that an SM holds fewer blocks of each tile kernel
(the factor 2 and 1 instead of 4, the solve 3 and 2; three more for the
streaming solve below).  Each build's kernels are held to the
shared-memory kernels bit for bit, then the production build and the two
capped ones are timed in turns (A B C C B A) with CUDA events, and the
production build at 132 and 528 lanes (one block an SM; one full wave).
Then the cluster factor (chol_factor_cluster_kernel) on the KKT matrices of
chip_smoke.py's dense_long phase (1,024 lanes, horizon 24, n = 288,
iteration 5): held to the shared-triangle kernel bit for bit in both
builds, timed at 66 (one cluster on every SM pair), 132 and 1,024 matrices,
with and without the clocks, and its chain of panels by phase
(-DCHOL_PHASE_CLOCKS: each step clocked by the thread on it, see chol.cu);
then on seeded random SPD batches of 1,024 across the route's range, in
turns with torch.linalg.cholesky: n = 288 (a multiple of 8: each tile row
moves as two float4), 252, 300 and 324 (horizons 21, 25, 27, multiples of
4: half rows as float4) and 249 and 339 (element by element).
Then the solve above n = 248 on the same iteration-5 KKT matrices and
their right-hand sides: the shared-memory solve's thread 0 by phase (its
load, forward and back sweeps; -DCHOL_PHASE_CLOCKS); the streaming solve
(chol_solve_stream_kernel) bit for bit it in every build, timed in turns
with it and torch.cholesky_solve, at 132, 528 and 1,024 matrices, with the
SM held to 8, 4 and 2 of its blocks (-DCHOL_EXTRA_SMEM: 6,000, 30,000 and
80,000 unused bytes a block), and its diagonal thread's cycles by phase
(waits for its copies, barriers, diagonal steps, issuing copies, its
updates); on seeded SPD batches of 1,024 at n = 249 ... 339 in turns with
the shared solve and the library; and at 4,096 x n = 120 (chol's KKT
matrices) in turns with the tile solve and the library (the route there
stays the tile solve).
Prints one JSON line per build, the phase shares, the timelines, the
card's name and power limit, and {"ok": true, ...} last.

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
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as CS

BATCH = 4096
REPS = 20
# unused dynamic bytes a block of either tile kernel asks for: with the
# factor's 8,224 B of static shared memory and 1 KB reserved, 2 and 1 of its
# blocks fit an SM's 228 KB; of the solve's (1,984 B), 3 and 2
EXTRA_SMEM = {'capped 70,000 B': 70000, 'capped 110,000 B': 110000}
STEP_BLOCKS, STEPS = 4096, 96   # chol.cu's CHOL_STEP_BLOCKS, CHOL_STEPS
PHASES = ('load', 'diagonal factor', 'waiting for the diagonal tile',
          'column solve', 'waiting for the panel', 'trailing update',
          'store')
# the cluster factor's phases (chol.cu, CHOL_PHASE_CLOCKS); 1-5 are the
# chain of a panel, one after another
CLUSTER_PHASES = ('load and the first cluster barrier',
                  'update of the next diagonal tile', 'diagonal factor',
                  'waiting for the diagonal tile', 'column solve and stores',
                  'cluster barrier', 'store', 'whole run')
CLUSTER_BATCHES = (66, 132, 1024)
CLUSTER_SIZES = (249, 252, 288, 300, 324, 339)
# the solves above 248 (chol.cu, CHOL_PHASE_CLOCKS, thread 0 of a block):
# kernel ids and phases
SOLVE_SHARED, SOLVE_STREAM = 3, 5
SHARED_SOLVE_PHASES = ('load', 'forward sweep', 'back sweep', 'store')
STREAM_PHASES = ('prologue (first panel issued, x and the reciprocals '
                 'loaded)', 'waiting for its copies',
                 'barrier after the copies', 'diagonal steps',
                 'issuing the next panel', 'barrier after the diagonal step',
                 'its own updates', 'store')
# unused dynamic bytes a block of the streaming solve asks for: beside its
# 20,736 B at n = 288 and 1 KB reserved, 8, 4 and 2 of its blocks fit an
# SM's 228 KB
STREAM_EXTRA_SMEM = {'stream 8 blocks': 6000, 'stream 4 blocks': 30000,
                     'stream 2 blocks': 80000}
STREAM_BATCHES = (132, 528, 1024)
STREAM_SIZES = (249, 252, 288, 300, 324, 336, 339)


def main():
    if not torch.cuda.is_available():
        print('profile_chol_kernel: no CUDA device', file=sys.stderr)
        sys.exit(1)
    from hector_torch import mpc as M
    from hector_torch.config import DEFAULT_CONFIG as CFG
    from hector_torch.qp import chol as CH

    card = CS.card_line()
    dev = torch.device('cuda')
    # one nvcc a build, all started together
    defines = {'phase clocks': ('-DCHOL_PHASE_CLOCKS',),
               'step clocks': ('-DCHOL_STEP_CLOCKS',)}
    for name, extra in {**EXTRA_SMEM, **STREAM_EXTRA_SMEM}.items():
        defines[name] = (f'-DCHOL_EXTRA_SMEM={extra}',)
    with ThreadPoolExecutor(len(defines) + 1) as pool:
        built = pool.submit(CH.build)
        variants = {k: pool.submit(CH.kernel_variant, v)
                    for k, v in defines.items()}
        production = built.result()
        builds = {'production': (production, CH.build_info)}
        builds.update({k: f.result() for k, f in variants.items()})
    qp = CS.scenario_problem(BATCH, 5, dev, M.build_dense)
    seen_m, seen_rhs = CS.kkt_matrices(qp, dataclasses.replace(
        CFG.solver, backend='auto', iterations=6))
    m, rhs = seen_m[-1], seen_rhs[-1]
    n = m.shape[1]
    ref = CH.factor_shared_cuda(m, torch.empty_like(m))
    x_ref = CH.solve_shared_cuda(ref, rhs, torch.empty_like(rhs))

    def with_lib(lib, fn):
        CH._lib = lib
        try:
            return fn()
        finally:
            CH._lib = production

    def factor(lib, b=BATCH):
        return with_lib(lib, lambda: CH.cholesky_bnn(m[:b]))

    def solve(lib, b=BATCH):
        return with_lib(lib, lambda: CH.cholesky_solve_bnn(ref[:b], rhs[:b]))

    times = {}
    for name, (lib, info) in builds.items():
        if not (CS.bit_equal(factor(lib), ref)
                and CS.bit_equal(solve(lib), x_ref)):
            raise RuntimeError(f'{name}: the factor or the solve differs '
                               f'from the shared-memory kernels')
        attr = {k: with_lib(lib, lambda: CH.kernel_attributes(n, k))
                for k in ('factor_tile', 'solve_tile')}
        used = [ln.strip() for ln in info.get('ptxas', '').splitlines()
                if 'Used' in ln]
        CS.emit(dict(build=name, attributes=attr, ptxas=used))
        times[name] = {'factor': [], 'solve': []}
    timed = ['production', *EXTRA_SMEM]
    for name in timed + timed[::-1]:
        lib = builds[name][0]
        times[name]['factor'].append(CS.cuda_ms(lambda: factor(lib), REPS))
        times[name]['solve'].append(CS.cuda_ms(lambda: solve(lib), REPS))
    by_batch = {b: {'factor': CS.cuda_ms(lambda: factor(production, b), REPS),
                    'solve': CS.cuda_ms(lambda: solve(production, b), REPS)}
                for b in (132, 528, BATCH)}
    CS.emit(dict(batch=BATCH, n=n, ms_turns={k: times[k] for k in timed},
                 ms_by_batch=by_batch, card=card))

    clocks = builds['phase clocks'][0]
    clocks.chol_phase_cycles.argtypes = [ctypes.c_void_p]
    clocks.chol_phase_cycles.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    for b in (132, BATCH):
        factor(clocks, b)                        # warm-up
        torch.cuda.synchronize()
        if clocks.chol_phase_cycles(out) != 0:
            raise RuntimeError('chol_phase_cycles failed')
        factor(clocks, b)
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

    # timelines: thread 0 of each block marks the SM clock after each
    # barrier; the mean over the blocks of each step, grouped by phase
    steps = builds['step clocks'][0]
    steps.chol_step_clocks.argtypes = [ctypes.c_void_p]
    steps.chol_step_clocks.restype = ctypes.c_int

    def timeline(fn, blocks, used):
        """Run fn; (mean cycles a block, mean cycles of each of its
        used - 1 steps)."""
        fn()
        torch.cuda.synchronize()
        buf = torch.zeros((STEP_BLOCKS, STEPS), dtype=torch.int64)
        if steps.chol_step_clocks(buf.data_ptr()) != 0:
            raise RuntimeError('chol_step_clocks failed')
        marks = buf[:blocks, :used].double()
        return ((marks[:, -1] - marks[:, 0]).mean().item(),
                (marks[:, 1:] - marks[:, :-1]).mean(0).tolist())

    nt = -(-n // 8)
    # marks: start, load, 2 a panel forward and back but 1 for the first
    # panel's back diagonal, end
    total, d = timeline(lambda: solve(steps), BATCH, 4 * nt)
    # load; the forward sweep's steps; the back sweep's; the store.  The
    # marking thread's clock can slip across a panel's two barriers once
    # its warp is idle, so only whole sweeps and panels are summed.
    groups = {'load': d[0], 'forward sweep': sum(d[1:2 * nt - 1]),
              'back sweep': sum(d[2 * nt - 1:4 * nt - 2]),
              'store': d[4 * nt - 2]}
    CS.emit(dict(kernel='chol_solve_kernel', batch=BATCH, n=n,
                 cycles_per_block=total, phase_cycles_per_block=groups,
                 step_cycles=[round(x) for x in d]))
    m_long, rhs_long = long_kkt(dev)
    cluster_profile(production, clocks, m_long)
    stream_profile(builds, m_long, rhs_long, (m, ref, rhs))
    print(card, flush=True)
    CS.emit({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}})


def long_kkt(dev):
    """The KKT matrices and first right-hand sides of chip_smoke.py's
    dense_long phase (1,024 lanes, horizon 24, n = 288) at iteration 5."""
    from hector_torch import mpc as M
    from hector_torch.config import DEFAULT_CONFIG as CFG

    long_cfg = dataclasses.replace(
        CS.with_solver(CFG, backend='dense_auto'),
        mpc=dataclasses.replace(CFG.mpc, horizon=CS.LONG_HORIZON))
    qp = CS.scenario_problem(CS.LONG_BATCH, 10, dev, M.build_dense, long_cfg)
    seen_m, seen_rhs = CS.kkt_matrices(qp, dataclasses.replace(
        long_cfg.solver, backend='auto', iterations=6))
    return seen_m[-1], seen_rhs[-1]


def cluster_profile(production, clocks, m):
    """The cluster factor at n = 288 on dense_long's iteration-5 KKT
    matrices: bit for bit, timed by batch in both builds, and its panels'
    chain by phase."""
    from hector_torch.qp import chol as CH

    dev = m.device
    n = m.shape[1]
    ref = CH.factor_shared_cuda(m, torch.empty_like(m))

    def factor(lib, b):
        CH._lib = lib
        try:
            return CH.factor_cluster_cuda(m[:b], torch.empty_like(m[:b]))
        finally:
            CH._lib = production

    libs = {'production': production, 'phase clocks': clocks}
    for name, lib in libs.items():
        if not CS.bit_equal(factor(lib, CS.LONG_BATCH), ref):
            raise RuntimeError(f'{name}: the cluster factor differs from '
                               f'the shared-triangle kernel')
    ms = {name: {b: [] for b in CLUSTER_BATCHES} for name in libs}
    for name in (*libs, *reversed(libs)):
        for b in CLUSTER_BATCHES:
            ms[name][b].append(CS.cuda_ms(lambda: factor(libs[name], b), REPS))
    clocks.chol_cluster_phase_cycles.argtypes = [ctypes.c_void_p]
    clocks.chol_cluster_phase_cycles.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * (len(CLUSTER_PHASES) + 1))()

    def launch_and_read(b):
        factor(clocks, b)
        torch.cuda.synchronize()
        if clocks.chol_cluster_phase_cycles(out) != 0:
            raise RuntimeError('chol_cluster_phase_cycles failed')

    phases = {}
    for b in (66, CS.LONG_BATCH):
        launch_and_read(b)                      # warm-up; zeroes the sums
        launch_and_read(b)
        cyc, mats = list(out[:len(CLUSTER_PHASES)]), out[len(CLUSTER_PHASES)]
        if mats != b:
            raise RuntimeError(f'{mats} matrices clocked, {b} launched')
        chain = sum(cyc[1:6])
        phases[b] = dict(
            cycles_per_matrix={p: c / mats for p, c in
                               zip(CLUSTER_PHASES, cyc)},
            chain_share={p: c / chain for p, c in
                         zip(CLUSTER_PHASES[1:6], cyc[1:6])},
            chain_over_whole_run=chain / cyc[7],
            panels=-(-n // 8) - 1)
    CS.emit(dict(kernel='chol_factor_cluster_kernel', n=n,
                 matrices='dense_long, iteration 5',
                 ms_by_batch={k: {str(b): v for b, v in d.items()}
                              for k, d in ms.items()},
                 attributes=CH.kernel_attributes(n, 'factor_cluster'),
                 phases={str(b): v for b, v in phases.items()}))

    # by n: the route's kernel and the library in turns on SPD batches
    by_n = {}
    for size in CLUSTER_SIZES:
        gen = torch.Generator(device=dev).manual_seed(size)
        x = torch.randn((CS.LONG_BATCH, size, size), generator=gen,
                        device=dev)
        m = x @ x.transpose(1, 2) / size + 1e-3 * torch.eye(size, device=dev)
        del x
        turns = {'cluster': [], 'library': []}
        fns = {'cluster': lambda: CH.cholesky_bnn(m),
               'library': lambda: torch.linalg.cholesky(m)}
        for name in ('cluster', 'library', 'library', 'cluster'):
            turns[name].append(CS.cuda_ms(fns[name], REPS))
        attr = CH.kernel_attributes(size, 'factor_cluster')
        by_n[str(size)] = dict(
            kernel=CH.route(size),
            tile_loads=('rows' if size % 8 == 0 else
                        'half rows' if size % 4 == 0 else 'elements'),
            ms_turns=turns, threads_per_block=attr['threads_per_block'],
            bound_ms=CS.bound_ms(
                CS.LONG_BATCH * CH.factor_bytes(size),
                CS.LONG_BATCH * sum(CH.factor_op_count(size).values()))[0])
        del m
    CS.emit(dict(kernel='chol_factor_cluster_kernel', batch=CS.LONG_BATCH,
                 matrices='seeded SPD', by_n=by_n))


def solve_phases(clocks, kernel, fn, names, blocks):
    """fn() in the CHOL_PHASE_CLOCKS build: thread 0's cycles a block by
    phase, and their shares, of solve kernel `kernel`."""
    clocks.chol_solve_phase_cycles.argtypes = [ctypes.c_int, ctypes.c_void_p]
    clocks.chol_solve_phase_cycles.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * 9)()
    for _ in range(2):                      # a warm-up, then the one read
        fn()
        torch.cuda.synchronize()
        if clocks.chol_solve_phase_cycles(kernel, out) != 0:
            raise RuntimeError('chol_solve_phase_cycles failed')
    cyc, got = list(out[:len(names)]), out[8]
    if got != blocks:
        raise RuntimeError(f'{got} blocks clocked, {blocks} launched')
    total = sum(cyc)
    return dict(cycles_per_block=total / got,
                phase_cycles_per_block={p: c / got for p, c in
                                        zip(names, cyc)},
                phase_share={p: c / total for p, c in zip(names, cyc)})


def stream_profile(builds, m, rhs, small):
    """The solve above 248: the shared-memory solve's phases, then the
    streaming solve on dense_long's iteration-5 KKT matrices (bit for bit,
    in turns, by batch, held to fewer blocks, by phase), by n on seeded SPD
    batches, and at n = 120 beside the tile solve (``small``: chol's
    iteration-5 matrices, their shared-kernel factors and right-hand
    sides)."""
    from hector_torch.qp import chol as CH

    production, clocks = builds['production'][0], builds['phase clocks'][0]
    dev, n, batch = m.device, m.shape[1], m.shape[0]
    ell = CH.factor_shared_cuda(m, torch.empty_like(m))

    def solve(lib, entry, ll=ell, r=rhs):
        CH._lib = lib
        try:
            return getattr(CH, entry)(ll, r, torch.empty_like(r))
        finally:
            CH._lib = production

    # the shared-memory solve's phases, taken before the streaming solve runs
    CS.emit(dict(kernel='chol_solve_smem_kernel', n=n, batch=batch,
                 matrices='dense_long, iteration 5',
                 attributes=CH.kernel_attributes(n, 'solve_shared'),
                 phases=solve_phases(
                     clocks, SOLVE_SHARED,
                     lambda: solve(clocks, 'solve_shared_cuda'),
                     SHARED_SOLVE_PHASES, batch)))
    x_ref = solve(production, 'solve_shared_cuda')
    for name, (lib, _) in builds.items():
        if not CS.bit_equal(solve(lib, 'solve_cuda'), x_ref):
            raise RuntimeError(f'{name}: the streaming solve differs from '
                               f'the shared-memory solve')
    rhs_col = rhs[..., None].contiguous()
    fns = {'stream': (lambda: solve(production, 'solve_cuda'), REPS),
           'shared': (lambda: solve(production, 'solve_shared_cuda'), 5),
           'library': (lambda: torch.cholesky_solve(rhs_col, ell), 5)}
    turns = {k: [] for k in fns}
    for name in ('stream', 'shared', 'library', 'library', 'shared',
                 'stream'):
        turns[name].append(CS.cuda_ms(*fns[name]))
    capped = {k: [] for k in STREAM_EXTRA_SMEM}
    for name in (*STREAM_EXTRA_SMEM, *reversed(STREAM_EXTRA_SMEM)):
        capped[name].append(CS.cuda_ms(
            lambda: solve(builds[name][0], 'solve_cuda'), REPS))
    blocks = {}
    for name in STREAM_EXTRA_SMEM:
        CH._lib = builds[name][0]
        try:
            blocks[name] = CH.kernel_attributes(n, 'solve_stream')[
                'blocks_per_sm']
        finally:
            CH._lib = production
    by_batch = {str(b): CS.cuda_ms(lambda: solve(
        production, 'solve_cuda', ell[:b], rhs[:b]), REPS)
        for b in STREAM_BATCHES}
    bound = CS.bound_ms(batch * CH.solve_bytes(n),
                        batch * sum(CH.solve_op_count(n).values()))
    phases = {str(b): solve_phases(
        clocks, SOLVE_STREAM,
        lambda: solve(clocks, 'solve_cuda', ell[:b], rhs[:b]),
        STREAM_PHASES, b) for b in (132, batch)}
    CS.emit(dict(kernel='chol_solve_stream_kernel', n=n, batch=batch,
                 matrices='dense_long, iteration 5', ms_turns=turns,
                 bound_ms=bound[0], bound_by=bound[1],
                 share_of_bound=bound[0] / (sum(turns['stream']) / 2),
                 attributes=CH.kernel_attributes(n, 'solve_stream'),
                 ms_held_to_blocks={f'{blocks[k]} blocks an SM': v
                                    for k, v in capped.items()},
                 ms_by_batch=by_batch, phases=phases))

    # by n: the route's kernel, the shared-memory solve and the library in
    # turns on seeded SPD batches
    by_n = {}
    for size in STREAM_SIZES:
        gen = torch.Generator(device=dev).manual_seed(size)
        x = torch.randn((batch, size, size), generator=gen, device=dev)
        ll = CH.cholesky_bnn(x @ x.transpose(1, 2) / size
                             + 1e-3 * torch.eye(size, device=dev))
        del x
        r = torch.randn((batch, size), generator=gen, device=dev)
        r_col = r[..., None].contiguous()
        fns = {'stream': (lambda: CH.cholesky_solve_bnn(ll, r), REPS),
               'shared': (lambda: CH.solve_shared_cuda(
                   ll, r, torch.empty_like(r)), 3),
               'library': (lambda: torch.cholesky_solve(r_col, ll), 3)}
        if not CS.bit_equal(fns['stream'][0](), fns['shared'][0]()):
            raise RuntimeError(f'the solves differ at n = {size}')
        turns = {k: [] for k in fns}
        for name in ('stream', 'shared', 'library', 'library', 'shared',
                     'stream'):
            turns[name].append(CS.cuda_ms(*fns[name]))
        by_n[str(size)] = dict(
            kernel=CH.route(size, 'solve'),
            copies=('16-byte chunks' if size % 4 == 0 else 'elements'),
            ms_turns=turns, bound_ms=CS.bound_ms(
                batch * CH.solve_bytes(size),
                batch * sum(CH.solve_op_count(size).values()))[0])
        del ll, r, r_col
    CS.emit(dict(kernel='chol_solve_stream_kernel', batch=batch,
                 matrices='seeded SPD', by_n=by_n))

    # n = 120: the streaming solve below its route, beside the tile solve
    m_s, l_s, rhs_s = small
    x_tile = CH.cholesky_solve_bnn(l_s, rhs_s)
    if not CS.bit_equal(CH.solve_stream_cuda(l_s, rhs_s,
                                             torch.empty_like(rhs_s)), x_tile):
        raise RuntimeError('the streaming solve differs from the tile solve '
                           'at n = 120')
    r_col = rhs_s[..., None].contiguous()
    fns = {'tile': (lambda: CH.cholesky_solve_bnn(l_s, rhs_s), REPS),
           'stream': (lambda: CH.solve_stream_cuda(
               l_s, rhs_s, torch.empty_like(rhs_s)), REPS),
           'library': (lambda: torch.cholesky_solve(r_col, l_s), 5)}
    turns = {k: [] for k in fns}
    for name in ('tile', 'stream', 'library', 'library', 'stream', 'tile'):
        turns[name].append(CS.cuda_ms(*fns[name]))
    CS.emit(dict(kernel='chol_solve_stream_kernel', n=m_s.shape[1],
                 batch=m_s.shape[0], matrices='chol, iteration 5',
                 route=CH.route(m_s.shape[1], 'solve'), ms_turns=turns,
                 attributes={k: CH.kernel_attributes(m_s.shape[1], k)
                             for k in ('solve_tile', 'solve_stream')}))


if __name__ == '__main__':
    main()
