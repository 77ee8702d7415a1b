"""PyTorch + CUDA port of the Hector MPC engine (``hector/`` is the JAX
reference it is held against).

The port imports torch, numpy and the standard library only -- never JAX and
nothing of ``hector/``.  Every function takes the scenario batch as an
explicit leading dimension where the JAX function is vmapped, and keeps the
JAX field names and layouts in its NamedTuples.

All solver math runs in true float32 on the card: reduced-precision
(TF32) products quantize forces far beyond the 1e-3 N parity contract
(hector/qp/riccati.py module docstring), so both TF32 switches are off.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def resolve_device(device) -> torch.device:
    """The device an entry point builds its state on.  'cuda' (the default
    of every entry point) raises when no card is present: there is no
    silent CPU fallback, the caller asks for the CPU explicitly."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the port on the CPU")
    return dev


_CONSTANTS = {}


def constant(key, values, like) -> torch.Tensor:
    """``values`` as a tensor with the dtype and device of ``like``, made
    once per (key, dtype, device) and shared: never write to it.  A copy
    from the host synchronises with the card, so a loop that builds its
    constants with ``torch.tensor(..., device='cuda')`` waits on the card
    at every call; this one does so once.  ``key`` is any hashable that
    names the values (a config dataclass is part of it where the values
    derive from one); ``values`` may be a function that makes them."""
    k = (key, like.dtype, like.device)
    t = _CONSTANTS.get(k)
    if t is None:
        if callable(values):
            values = values()
        t = _CONSTANTS[k] = torch.as_tensor(values, dtype=like.dtype).to(
            like.device)
    return t


# the data-parallel layer, exported as hector/__init__.py exports its own
# (imported last: it builds on the helpers above)
from . import parallel  # noqa: E402
