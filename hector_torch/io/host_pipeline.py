"""Host pipeline: native scenario generation overlapped with device compute
(port of ``hector/io/host_pipeline.py``).

Scenario batches are generated by the native library
``native/scenario_gen.cpp`` (g++ at first use, into
``hector_torch/_build/``) on the host, copied to the card and
double-buffered, so that generation and the copy of batch k+1 overlap the
card's work on batch k:

    stream = ScenarioStream(batch=32768, seed=7)
    for k, cmd in zip(range(n_steps), stream):
        carry, plant, metrics = rollout(carry, plant, cmd)

Determinism: row i of step k depends only on (seed, k, i) (splitmix64
streams in the native generator), so shards regenerate identically and a
resumed run replays the exact scenario sequence.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _native, resolve_device
from .. import runtime as RT

N_COLS = 11
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        so, _ = _native.build('g++',
                              [_native.NATIVE_DIR / 'scenario_gen.cpp'],
                              'scenario_gen', _native.GXX_FLAGS)
        lib = ctypes.CDLL(str(so))
        lib.generate_scenarios.argtypes = [
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        lib.generate_scenarios.restype = None
        _LIB = lib
    return _LIB


def generate_host(seed: int, batch: int, p_standing: float = 0.1,
                  p_stairs: float = 0.0, max_step_height: float = 0.04,
                  row_begin: int = 0, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """Rows [row_begin, row_begin + batch) as a (batch, 11) float32 array
    (column layout in native/scenario_gen.cpp); the seed is taken as an
    unsigned 64-bit value.  ``out``: a C-contiguous (batch, 11) float32
    array to fill in place of a new one."""
    if out is None:
        out = np.empty((batch, N_COLS), dtype=np.float32)
    if (out.shape != (batch, N_COLS) or out.dtype != np.float32
            or not out.flags.c_contiguous):
        raise ValueError(f'out must be a C-contiguous ({batch}, {N_COLS}) '
                         f'float32 array')
    _lib().generate_scenarios(
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), ctypes.c_int64(row_begin),
        ctypes.c_int64(row_begin + batch), ctypes.c_float(p_standing),
        ctypes.c_float(p_stairs), ctypes.c_float(max_step_height),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def rows_to_command(rows) -> RT.ScenarioCommand:
    """(batch, 11) rows (a tensor, or an array taken as a tensor without a
    copy) -> ScenarioCommand of views of them."""
    rows = torch.as_tensor(rows)
    return RT.ScenarioCommand(
        vx=rows[:, 0], vy=rows[:, 1], yaw_rate=rows[:, 2],
        roll=rows[:, 3], pitch=rows[:, 4],
        gait_offsets=rows[:, 5:7], gait_durations=rows[:, 7:9],
        terrain_step_height=rows[:, 9], terrain_step_length=rows[:, 10])


class ScenarioStream:
    """Double-buffered scenario iterator.

    One worker thread generates batch k+1 (native code) into one of two
    pinned host buffers and enqueues its copy to the card on a side stream,
    recording an event, while the caller's stream works on batch k.
    ``next()`` makes the caller's current stream wait on that event and
    returns the command: no host synchronisation on the caller's side.  A
    pinned buffer is written again only after the event of its last copy
    has fired (the worker waits on it).  With a mesh, the rows split into
    contiguous shards, each copied to its device, and ``next()`` gives a
    tuple of per-device commands (parallel.shard_batch's layout).  On the
    CPU the rows are generated into a fresh array and used in place.
    """

    def __init__(self, batch: int, seed: int = 0,
                 mesh: Optional[Sequence[torch.device]] = None,
                 p_standing: float = 0.1, p_stairs: float = 0.0,
                 max_step_height: float = 0.04, device='cuda'):
        self.batch = batch
        self.seed = seed
        self.mesh = tuple(mesh) if mesh is not None else None
        devices = self.mesh or (resolve_device(device),)
        if batch % len(devices):
            raise ValueError(f'batch {batch} does not split evenly over '
                             f'{len(devices)} devices')
        self._devices = devices
        self._params = (p_standing, p_stairs, max_step_height)
        self._cuda = devices[0].type == 'cuda'
        if self._cuda:
            self._host = [torch.empty((batch, N_COLS), dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self._copied = [None, None]     # events of each buffer's copies
            self._streams = {d: torch.cuda.Stream(d) for d in set(devices)}
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._step = 0
        self._pending = self._pool.submit(self._make, self._step)

    def _make(self, step: int):
        """Generate step ``step``'s rows and start their copies; runs on
        the worker thread.  Returns (per-device row tensors, per-device
        events or None)."""
        seed = self.seed + (step << 32)   # one row stream per step
        if not self._cuda:
            rows = torch.from_numpy(generate_host(seed, self.batch,
                                                  *self._params))
            return rows.chunk(len(self._devices)), None
        slot = step % 2
        for ev in self._copied[slot] or ():
            ev.synchronize()                # its last copies have landed
        host = self._host[slot]
        generate_host(seed, self.batch, *self._params, out=host.numpy())
        size = self.batch // len(self._devices)
        rows, events = [], []
        for i, dev in enumerate(self._devices):
            stream = self._streams[dev]
            with torch.cuda.stream(stream):
                dst = torch.empty((size, N_COLS), dtype=torch.float32,
                                  device=dev)
                dst.copy_(host[i * size:(i + 1) * size], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            rows.append(dst)
            events.append(ev)
        self._copied[slot] = events
        return rows, events

    def __iter__(self):
        return self

    def __next__(self):
        rows, events = self._pending.result()
        self._step += 1
        self._pending = self._pool.submit(self._make, self._step)
        if events is not None:
            for r, ev in zip(rows, events):
                consumer = torch.cuda.current_stream(r.device)
                consumer.wait_event(ev)
                # made on the side stream, used on the consumer's: keep the
                # allocator from reusing it before the consumer is done
                r.record_stream(consumer)
        cmds = tuple(rows_to_command(r) for r in rows)
        return cmds if self.mesh is not None else cmds[0]

    def wait(self):
        """Block until the batch in flight has been generated and copied
        (to time work without a batch in flight)."""
        _, events = self._pending.result()
        for ev in events or ():
            ev.synchronize()

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
