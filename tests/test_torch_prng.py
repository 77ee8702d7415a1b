"""The port's copy of jax.random (``hector_torch/prng.py``) against JAX's
threefry2x32 stream in its partitionable layout, on the CPU.

Keys, raw bits and the uniforms behind ``normal`` must equal JAX's bit for
bit: a key one word off would put every noisy parity test O(sigma) out.
Normals go through erfinv: the port evaluates XLA's own polynomials with
torch's log1p and sqrt, so float32 normals are held to 4 ulps (measured 3)
and float64 to 1e-13 relative (measured 3.4e-15; torch.erfinv itself is up
to 63 ulps and 1e-13 relative from XLA's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hector_torch import prng

torch.set_num_threads(1)

I64 = torch.int64


def _keys(seed, n):
    """n random JAX keys (uint32 words) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _t(keys):
    return torch.tensor(np.asarray(keys).astype(np.int64), dtype=I64)


def _jax_assert_equal(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_threefry_partitionable_is_the_reference_layout():
    """The layout this port copies is the one the JAX package runs."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == 'threefry2x32'


@pytest.mark.parametrize('seed', [0, 1, 7, 42, 2 ** 31, 2 ** 32 + 5,
                                  2 ** 40 + 3, -1])
def test_prngkey_matches_jax(seed):
    _jax_assert_equal(jax.random.PRNGKey(seed), prng.PRNGKey(seed, 'cpu'))


def test_prngkey_of_a_seed_tensor_is_one_key_per_seed():
    seeds = torch.tensor([0, 3, 2 ** 33 + 1])
    _jax_assert_equal(jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds]),
                      prng.PRNGKey(seeds, 'cpu'))


@pytest.mark.parametrize('num', [1, 2, 3, 4, 5, 16])
def test_split_matches_jax(num):
    keys = _keys(num, 64)
    j = jax.vmap(lambda k: jax.random.split(k, num))(jnp.asarray(keys))
    _jax_assert_equal(j, prng.split(_t(keys), num))


def test_split_broadcasts_over_leading_dimensions():
    keys = _keys(3, 12)
    j = jax.vmap(lambda k: jax.random.split(k, 3))(jnp.asarray(keys))
    t = prng.split(_t(keys).reshape(3, 4, 2), 3)
    assert t.shape == (3, 4, 3, 2)
    _jax_assert_equal(np.asarray(j).reshape(3, 4, 3, 2), t)


def test_fold_in_matches_jax():
    keys = _keys(5, 6)
    data = np.array([0, 1, 5, 2 ** 31, 2 ** 32 - 1, 123456789], np.uint32)
    j = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data))
    _jax_assert_equal(j, prng.fold_in(_t(keys), torch.tensor(
        data.astype(np.int64))))
    # one key folded with every lane's index, as the rollouts seed lanes
    lanes = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(7),
                                                    jnp.arange(8))
    _jax_assert_equal(lanes, prng.fold_in(prng.PRNGKey(7, 'cpu'),
                                          torch.arange(8)))


def test_bits_match_jax():
    keys = _keys(6, 32)
    j32 = jax.vmap(lambda k: jax.random.bits(k, (7,), jnp.uint32))(
        jnp.asarray(keys))
    _jax_assert_equal(j32, prng.bits(_t(keys), 7, 32))
    j64 = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (7,), jnp.uint64))(
        jnp.asarray(keys)))
    w = prng.bits(_t(keys), 7, 64).numpy().astype(np.uint64)
    np.testing.assert_array_equal((w[..., 0] << np.uint64(32)) | w[..., 1],
                                  j64)


@pytest.mark.parametrize('jdtype,tdtype', [(jnp.float32, torch.float32),
                                           (jnp.float64, torch.float64)],
                         ids=['f32', 'f64'])
def test_uniforms_behind_normal_match_jax_bit_for_bit(jdtype, tdtype):
    keys = _keys(8, 4000)
    lo = np.nextafter(np.array(-1.0, jdtype), np.array(0.0, jdtype))
    j = jax.vmap(lambda k: jax.random.uniform(k, (2, 3), jdtype, lo, 1.0))(
        jnp.asarray(keys))
    t = prng.uniform_pm1(_t(keys), 6, tdtype)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).reshape(4000, 6))


@pytest.mark.parametrize('jdtype,tdtype', [(jnp.float32, torch.float32),
                                           (jnp.float64, torch.float64)],
                         ids=['f32', 'f64'])
def test_normal_matches_jax(jdtype, tdtype):
    keys = _keys(9, 20000)
    j = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2, 3), jdtype))(
        jnp.asarray(keys)))
    t = prng.normal(_t(keys), (2, 3), tdtype).numpy()
    assert t.shape == (20000, 2, 3) and t.dtype == j.dtype
    if tdtype == torch.float32:
        assert (np.abs(t - j) <= 4 * np.spacing(np.abs(j))).all()
    else:
        assert (np.abs(t - j) <= 1e-13 * np.abs(j) + 1e-300).all()
    # the draw itself: standard normal moments over 120,000 samples
    assert abs(t.mean()) < 0.02 and abs(t.std() - 1.0) < 0.02
