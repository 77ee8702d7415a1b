"""The counter-based PRNG the estimators draw their sensor noise from: a
copy of ``jax.random``'s default ``threefry2x32`` stream in its
partitionable layout (``jax_threefry_partitionable=True``, the default
since JAX 0.5), so that a noisy rollout of the port can be held to the JAX
package lane by lane.

A key is an int64 tensor of shape (..., 2) holding the two uint32 words of
a JAX key; every function broadcasts over the leading dimensions, so a
(B, 2) tensor is one key a lane.  The uint32 arithmetic runs in int64 with
32-bit masks (a CUDA ``uint32`` tensor lacks shifts and multiplies), so the
stream is the same bit for bit on the CPU and on the card.

Keys and raw bits equal JAX's.  ``normal`` maps the bits to uniforms as JAX
does (exactly) and then through XLA's own erfinv approximations, evaluated
with torch's log1p and sqrt: normals agree to a few ulps in float32 and to
about 1e-14 relative in float64 (tests/test_torch_prng.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import resolve_device

MASK = 0xFFFFFFFF
# threefry2x32's rotation schedule and key-parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2); int64 tensors holding uint32 values,
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed, device='cuda') -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & MASK).
    ``seed`` is an int (a (2,) key) or an integer tensor of any shape (one
    key per entry)."""
    dev = resolve_device(device)
    seed = torch.as_tensor(seed, dtype=torch.int64).to(dev)
    return torch.stack([(seed >> 32) & MASK, seed & MASK], dim=-1)


def _bits_pair(key, n):
    """The two threefry words at counters 0..n-1 (high word 0, as JAX's
    iota_2x32_shape gives for fewer than 2**32 entries): (..., n) each."""
    counter = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2],
                        torch.zeros_like(counter), counter)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``, partitionable layout: key i is the
    hash of the counter pair (0, i).  (..., 2) -> (..., num, 2)."""
    b1, b2 = _bits_pair(key, num)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data as uint32).  ``data`` (an int or an integer tensor) broadcasts
    with the key's leading dimensions."""
    data = torch.as_tensor(data, dtype=torch.int64).to(key.device) & MASK
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b1, b2], dim=-1)


def bits(key, n: int, width: int = 32) -> torch.Tensor:
    """``jax.random.bits`` of ``n`` entries as int64 tensors (..., n).
    32-bit words are w1 ^ w2.  A 64-bit word is (w1 << 32) | w2, which does
    not fit an int64; it is returned as the pair (w1, w2) of shape
    (..., n, 2)."""
    b1, b2 = _bits_pair(key, n)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return torch.stack([b1, b2], dim=-1)
    raise ValueError(f'width must be 32 or 64, got {width}')


def uniform_pm1(key, n: int, dtype) -> torch.Tensor:
    """The uniforms jax.random.normal draws, bit for bit: the mantissa bits
    of one word an entry as a float in [0, 1), scaled to (-1, 1) and
    clamped at the float after -1.  (..., n) in ``dtype``."""
    if dtype == torch.float32:
        mant = bits(key, n, 32) >> 9                          # 23 bits
        floats = mant.to(torch.float32) * 2.0 ** -23
    elif dtype == torch.float64:
        w = bits(key, n, 64)                                   # 52 bits
        mant = ((w[..., 0] << 20) | (w[..., 1] >> 12))
        floats = mant.to(torch.float64) * 2.0 ** -52
    else:
        raise ValueError(f'normal draws float32 or float64, got {dtype}')
    lo = math.nextafter(-1.0, 0.0) if dtype == torch.float64 else \
        -1.0 + 2.0 ** -24
    # (1 - lo) rounds to 2 in either type, so floats * 2 + lo is one
    # rounding, as in jax.random.uniform
    return torch.clamp(floats * 2.0 + lo, min=lo)


def _two_sum(a, b):
    """s + t == a + b exactly, s = fl(a + b) (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma(a, b, c):
    """a * b + c rounded once (a fused multiply-add), elementwise on
    float32 or float64 tensors, for finite values whose products neither
    overflow nor underflow.  The product is split exactly (Dekker's
    TwoProduct), the three terms summed exactly as s + u + v (TwoSum), and
    fl(s + u) moved to its neighbour in the one case v decides: a tie."""
    split = 4097.0 if a.dtype == torch.float32 else 134217729.0

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    ah, al = halves(a)
    bh, bl = halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl   # a * b == p + e
    s, t = _two_sum(p, c)
    u, v = _two_sum(t, e)                       # a * b + c == s + u + v
    r, w = _two_sum(s, u)                       # r = fl(s + u), error w
    nxt = torch.nextafter(r, r + w)
    tie = (w != 0) & (nxt - r == 2 * w)
    return torch.where(tie & (v * w > 0), nxt, r)


def uniform(key, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: the
    mantissa bits of one word an entry as a float in [0, 1) (one 32-bit
    word in float32, one 64-bit word in float64), times (maxval - minval)
    plus minval, each rounded in ``dtype``, clamped below at minval.
    (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = math.prod(shape)
    if dtype == torch.float32:
        floats = (bits(key, n, 32) >> 9).to(torch.float32) * 2.0 ** -23
    elif dtype == torch.float64:
        w = bits(key, n, 64)
        mant = (w[..., 0] << 20) | (w[..., 1] >> 12)
        floats = mant.to(torch.float64) * 2.0 ** -52
    else:
        raise ValueError(f'uniform draws float32 or float64, got {dtype}')
    # the bounds and their difference in dtype, as JAX converts them
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np_dtype(minval)
    span = float(np_dtype(maxval) - lo)
    # XLA contracts floats * span + lo into one fused multiply-add
    out = torch.clamp(fma(floats, torch.full_like(floats, span),
                          torch.full_like(floats, float(lo))),
                      min=float(lo))
    return out.reshape(out.shape[:-1] + shape)


# Giles' erfinv approximations, the ones XLA evaluates (its ErfInv32 and
# ErfInv64): with w = -log1p(-x^2), a polynomial in one shifted argument per
# range of w, highest power first, times x.
# float32: w < 5 in w - 2.5, else in sqrt(w) - 3
_ERFINV32 = (
    (5.0, 2.5, False,
     (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
      0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
      1.50140941)),
    (None, 3.0, True,
     (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
      0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
      2.83297682)))
# float64: w < 6.25 in w - 3.125, w < 16 in sqrt(w) - 3.25, else in
# sqrt(w) - 5
_ERFINV64 = (
    (6.25, 3.125, False,
     (-3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18, 1.115787767802518096e-17,
      -1.333171662854620906e-16, 2.0972767875968561637e-17,
      6.6376381343583238325e-15, -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09, -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352, -0.00074070253416626697512,
      -0.0060336708714301490533, 0.24015818242558961693,
      1.6536545626831027356)),
    (16.0, 3.25, True,
     (2.2137376921775787049e-09, 9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06, -4.013867526981545969e-06,
      2.9234449089955446044e-06, 1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05, -0.0003550375203628474796,
      0.00095328937973738049703, -0.0016882755560235047313,
      0.0024914420961078508066, -0.0037512085075692412107,
      0.005370914553590063617, 1.0052589676941592334,
      3.0838856104922207635)),
    (None, 5.0, True,
     (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09, -3.7894654401267369937e-09,
      7.6157012080783393804e-09, -1.4960026627149240478e-08,
      2.9147953450901080826e-08, -6.7711997758452339498e-08,
      2.2900482228026654717e-07, -9.9298272942317002539e-07,
      4.5260625972231537039e-06, -1.9681778105531670567e-05,
      7.5995277030017761139e-05, -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221)))


def erfinv(x):
    """erfinv on |x| < 1 as XLA approximates it, so that the port's normals
    are JAX's to a few ulps (torch.erfinv is up to ~60 ulps from XLA's in
    float32 and 1e-13 relative in float64).  Each range's polynomial is
    evaluated on every entry and the range of w picks one."""
    w = -torch.log1p(-x * x)
    root = torch.sqrt(w)
    out = None
    for upper, shift, in_root, coeffs in reversed(
            _ERFINV32 if x.dtype == torch.float32 else _ERFINV64):
        arg = (root if in_root else w) - shift
        p = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            p = c + p * arg
        out = p if out is None else torch.where(w < upper, p, out)
    return out * x


def normal(key, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    u = uniform_pm1(key, math.prod(shape), dtype)
    out = math.sqrt(2.0) * erfinv(u)
    return out.reshape(out.shape[:-1] + shape)
