"""Capture a fixed-shape step once as a CUDA graph and replay it.

The JAX package compiles its loops: ``make_rollout`` is ``jax.jit`` of a
``lax.scan`` over the MPC periods (hector/runtime.py:351-368) and
``bench.py`` jits a ``lax.scan`` of the planning step (bench.py:75-88).
PyTorch runs eagerly, and one period of the tier-1 loop issues thousands of
small ops from the host.  The port's counterpart of ``jax.jit`` over such a
body is a CUDA graph: :class:`StepGraph` records one step once per shapes,
dtypes and device of its arguments and replays it once per step of the
scan.  The JAX package has no such module.

A step is ``step(state, inputs, i) -> (state', out)`` over trees of tensors
(nested NamedTuples, dicts, tensors).  ``state`` is the scan's carry;
``inputs`` stay fixed for a run, and a per-step input is read at ``i``, a
(1,) int64 tensor on the device that counts the steps of the run
(``x.index_select(1, i)``); ``out`` is the step's output, stacked over the
run along dim 1, after the batch.  The captured region is the step, the write of
``out`` into its slot of the stacked outputs, the copy of ``state'`` into
the state buffers and ``i += 1``, so n replays chain with nothing launched
in between.  A call copies its arguments into the static buffers, replays
n times and returns clones: nothing it returns aliases graph memory or a
buffer, as ``jax.jit`` returns fresh arrays.

Capture runs the step WARMUP times on a side stream first (that builds the
kernels, creates the library handles and fills ``hector_torch.constant``'s
cache), then records it under ``torch.cuda.graph``.  Nothing catches a
capture or replay error: a step that cannot be captured raises, and a
caller that must not capture a path says so by its own rule
(``runtime.GRAPH_BACKENDS``).

On CPU tensors nothing is captured: each replay runs the same captured
region eagerly on the same static buffers, so the buffer logic, the
chaining and the clones out are the card's.

Launch counters: a kernel wrapper counts its launches in a Python counter
(``fused_riccati.launches`` and the like), which moves once while the step
is recorded and never when the graph replays.  The launches of the warm-up
and of the capture are set-up, as JAX's compile is, and are taken back out
of the counters; each replay adds what the capture moved them by.  So a
counter reads after a run what the same run made eagerly reads.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

WARMUP = 2          # eager runs of the step on a side stream before capture
# held by a capture and by a replay's update of the launch counters: a
# capture's set-up frees cached device memory, holds off the cyclic GC and
# puts the counters back as they were, all process-wide, so threads that
# drive cards of their own (a thread a card) capture in turns and lose no
# count.  Reentrant: a step may call another StepGraph (pdip.make_solver's
# solve), which captures and replays in the outer capture's warm-up.
_LOCK = threading.RLock()


def kernel_counters():
    """The launch counters of the port's kernel wrappers, as (module,
    attribute name) pairs."""
    from .qp import chol, fused_riccati
    return ((fused_riccati, 'launches'), (fused_riccati, 'polish_launches'),
            (chol, 'factor_launches'), (chol, 'factor_shared_launches'),
            (chol, 'factor_cluster_launches'), (chol, 'solve_launches'),
            (chol, 'solve_shared_launches'), (chol, 'solve_stream_launches'))


def leaves(tree):
    """The tensors of a tree (NamedTuple, tuple, dict in key order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        values = [tree_map(fn, v) for v in tree]
        return (type(tree)(*values) if hasattr(tree, '_fields')
                else tuple(values))
    return fn(tree)


def _signature(tree):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves(tree))


class StepGraph:
    """``step`` replayed ``n_steps`` times a call: ``graphed(state,
    inputs) -> (state after n steps, outs stacked along dim 1)``.

    The captures are kept per shapes, dtypes and devices of the arguments
    (``captures``), so a batch size, a dtype or a card of its own gets a
    capture of its own.  ``counters``: the launch counters to carry over
    replays, default :func:`kernel_counters`."""

    def __init__(self, step, n_steps: int, counters=None):
        if n_steps < 1:
            raise ValueError(f'n_steps must be at least 1, got {n_steps}')
        self.step, self.n_steps = step, n_steps
        self.counters = (kernel_counters() if counters is None
                         else tuple(counters))
        self.captures = {}

    def __call__(self, state, inputs):
        key = _signature((state, inputs))
        cap = self.captures.get(key)
        if cap is None:
            cap = self.captures[key] = Capture(
                self.step, self.n_steps, self.counters, state, inputs)
        return cap.run(state, inputs)


def _read(counters):
    return [getattr(obj, name) for obj, name in counters]


def _write(counters, values):
    for (obj, name), v in zip(counters, values):
        setattr(obj, name, v)


class Capture:
    """The static buffers of one argument signature and, on the card, its
    graph.  ``seconds``: the warm-up and capture's wall time; ``graph``:
    the ``torch.cuda.CUDAGraph`` (None on the CPU).  It holds no reference
    to its StepGraph, so that no cycle keeps a graph alive until a
    collection, which could then come in the middle of another capture."""

    def __init__(self, step, n_steps, counters, state, inputs):
        self.step, self.n_steps, self.counters = step, n_steps, counters
        self.device = leaves((state, inputs))[0].device
        self.state = tree_map(torch.clone, state)
        self.inputs = tree_map(torch.clone, inputs)
        self.i = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.outs = None
        self.graph = None
        self.delta = None
        self.seconds = 0.0
        if self.device.type == 'cuda':
            self._capture()

    def _context(self):
        if self.device.type == 'cuda':
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _alloc_outs(self, out):
        self.outs = tree_map(
            lambda o: torch.empty(o.shape[:1] + (self.n_steps,) + o.shape[1:],
                                  dtype=o.dtype, device=o.device), out)

    def _body(self):
        """The captured region: one step, its output into slot i, the new
        state into the state buffers, i + 1."""
        new_state, out = self.step(self.state, self.inputs, self.i)
        if self.outs is None:
            self._alloc_outs(out)
        for buf, o in zip(leaves(self.outs), leaves(out)):
            buf.index_copy_(1, self.i, o.unsqueeze(1))
        bufs = leaves(self.state)
        storages = {b.untyped_storage().data_ptr() for b in bufs}
        new = [s.clone() if s is not b and
               s.untyped_storage().data_ptr() in storages else s
               for b, s in zip(bufs, leaves(new_state), strict=True)]
        for buf, s in zip(bufs, new):
            buf.copy_(s)
        self.i += 1

    def _capture(self):
        t0 = time.perf_counter()
        counters = self.counters
        saved = _read(counters)
        with _LOCK, self._context():
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    _, out = self.step(self.state, self.inputs, self.i)
            main.wait_stream(side)
            self._alloc_outs(out)
            del out
            # kept after instantiation, so that its nodes can be read
            # (raw_cuda_graph)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = _read(counters)
            # a graph freed while this one records (its destructor calls into
            # CUDA) spoils the capture: collect what is garbage now,
            # and let no collection run until the capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                # on the warm-up's stream, which lies on this card (the
                # default capture stream is made once, on the first card
                # that captured); thread_local: only this thread's calls
                # are held to what a capture allows, so that threads
                # driving other cards (a thread a card, profile_mesh.py)
                # go on while it records
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode='thread_local'):
                    self._body()
            finally:
                if collecting:
                    gc.enable()
            graph.instantiate()
            self.delta = [a - b for a, b in zip(_read(counters), before)]
            _write(counters, saved)
            torch.cuda.synchronize()
        self.graph = graph
        self.seconds = time.perf_counter() - t0

    def replay(self):
        """One step: the graph on the card (its launches added to the
        counters), the captured region run eagerly on the CPU."""
        if self.graph is None:
            self._body()
            return
        self.graph.replay()
        with _LOCK:
            _write(self.counters, [v + d for v, d in
                                   zip(_read(self.counters), self.delta)])

    def load(self, state, inputs):
        """The caller's arguments into the static buffers, the step count
        to 0."""
        for buf, x in zip(leaves((self.state, self.inputs)),
                          leaves((state, inputs)), strict=True):
            buf.copy_(x)
        self.i.zero_()

    def run(self, state, inputs):
        with self._context():
            self.load(state, inputs)
            for _ in range(self.n_steps):
                self.replay()
            return (tree_map(torch.clone, self.state),
                    tree_map(torch.clone, self.outs))
