"""The port's threefry PRNG against ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``), on the CPU.

Integer and uniform draws, and ``choice(p=)``, must be bitwise equal:
every k-means++ seed of the port comes from them. ``normal`` goes through
the inverse error function; the port evaluates XLA's float32 formula and
is held to 2 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 1, 42, 12345)


def _np(t):
    return t.cpu().numpy()


def test_known_vector():
    """PRNGKey(0) bits from the reference, written out."""
    got = _np(prng.bits(prng.PRNGKey(0), (4,)))
    assert got.tolist() == [4070199207, 4202968722, 1427181096, 2012915765]


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_bits(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert (np.asarray(jk).astype(np.int64) == _np(tk)).all()
    assert (np.asarray(jax.random.split(jk, 5)).astype(np.int64)
            == _np(prng.split(tk, 5))).all()
    assert (np.asarray(jax.random.fold_in(jk, 9)).astype(np.int64)
            == _np(prng.fold_in(tk, 9))).all()
    assert (np.asarray(jax.random.bits(jk, (3, 7))).astype(np.int64)
            == _np(prng.bits(tk, (3, 7)))).all()


def test_batched_keys_match_per_key_draws():
    """A (B, 2) key stack draws what each key draws alone."""
    keys = prng.split(prng.PRNGKey(3), 4)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 4)
    got = _np(prng.uniform(keys, (6,)))
    want = np.stack([np.asarray(jax.random.uniform(k, (6,))) for k in jkeys])
    assert (got == want).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_successive_splits(seed):
    """``split_chain`` (walked on the host) gives the subkeys of successive
    ``key, sub = split(key)`` steps, as the reference's k-means++ takes
    them, for a batch of keys."""
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = []
    for jk in jkeys:
        subs = []
        for _ in range(40):
            jk, sub = jax.random.split(jk)
            subs.append(np.asarray(sub).astype(np.int64))
        want.append(subs)
    got = prng.split_chain(prng.split(prng.PRNGKey(seed), 3), 40)
    assert got.shape == (3, 40, 2)
    assert (_np(got) == np.asarray(want)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed):
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (2000,)))
    assert (_np(prng.uniform(prng.PRNGKey(seed), (2000,))) == ju).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 120000), (5, 70000),
                                   (0, 2**31 - 1)])
def test_randint_bitwise(seed, lo, hi):
    jr = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (500,),
                                       lo, hi))
    assert (_np(prng.randint(prng.PRNGKey(seed), (500,), lo, hi))
            == jr).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [7, 100, 6861, 40000])
def test_choice_with_p_bitwise(seed, n):
    """Cumulative sums follow XLA's blocked order, so draws land on the
    same side of every boundary."""
    p = np.random.default_rng(seed).random(n).astype(np.float32)
    p /= p.sum()
    subs = jax.random.split(jax.random.PRNGKey(seed), 40)
    want = np.asarray(jax.vmap(
        lambda s: jax.random.choice(s, n, p=jnp.asarray(p)))(subs))
    got = _np(prng.choice(prng.split(prng.PRNGKey(seed), 40),
                          torch.from_numpy(p).expand(40, n)))
    assert (got == want).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_2_ulp(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (256, 15)))
    got = _np(prng.normal(prng.PRNGKey(seed), (256, 15)))
    spacing = np.spacing(np.maximum(np.abs(want), np.abs(got))
                         .astype(np.float32))
    ulps = np.abs(want.astype(np.float64) - got) / spacing
    assert ulps.max() <= 2.0, ulps.max()


def test_erf_inv_within_2_ulp():
    u = np.linspace(-0.999999, 0.999999, 20001, dtype=np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = _np(prng.erf_inv(torch.from_numpy(u)))
    spacing = np.spacing(np.maximum(np.abs(want), np.abs(got))
                         .astype(np.float32))
    ulps = np.abs(want.astype(np.float64) - got) / spacing
    assert ulps.max() <= 2.0, ulps.max()


def test_seed_out_of_int32_range_raises():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
