"""The port's threefry PRNG against ``jax.random`` (partitionable threefry,
x64 off): every key and draw must be bit-equal, or the port's samples and
chosen attributes would differ from the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.stable_hash import stable_hash32
from repro_torch import prng

torch.set_num_threads(1)  # small tensors; leave the cores to the other xdist workers


def _np(t):
    return np.asarray(t).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 9, 123456, -1, 2**31 - 1])
def test_prng_key(seed):
    assert (_np(prng.PRNGKey(seed)) == _np(jax.random.PRNGKey(seed))).all()


def test_prng_key_out_of_range_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(1 << 32)


@pytest.mark.parametrize("data", [0, 1, 7, stable_hash32(("crimes", ("year",))), 2**31 - 1])
def test_fold_in(data):
    """Call sites: the engine's per-query key (``fold_in(base, hash)``) and
    the estimate-stage key (``fold_in(k_e, 1)``)."""
    for seed in (0, 9):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        got = prng.fold_in(prng.PRNGKey(seed), data)
        assert (_np(got) == _np(want)).all()


@pytest.mark.parametrize("num", [1, 2, 3, 50])
def test_split(num):
    """Call sites: ``split(key)`` in selection and AQR, ``split(key, 50)`` in
    the bootstrap."""
    key = jax.random.fold_in(jax.random.PRNGKey(9), 12345)
    got = prng.split(torch.from_numpy(_np(key).astype(np.int64)), num)
    assert got.shape == (num, 2)
    assert (_np(got) == _np(jax.random.split(key, num))).all()


@pytest.mark.parametrize("n", [1, 2, 7, 1001, 20_000])
def test_uniform(n):
    """Call site: one float32 per row in sampling (odd lengths and n = 1)."""
    key = jax.random.split(jax.random.PRNGKey(3))[1]
    want = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float32))
    got = prng.uniform(torch.from_numpy(_np(key).astype(np.int64)), (n,), device="cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_uniform_batched_over_split_keys():
    """Call site: the bootstrap's ``vmap`` of uniform over ``split(key, 50)``."""
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 50)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (333,)))(keys))
    got = prng.uniform(prng.split(prng.PRNGKey(11), 50), (333,), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_uniform_chain_matches_engine_keys():
    """The whole derivation chain of one selection: seed -> fold_in(hash) ->
    split -> split -> uniform."""
    h = stable_hash32(("crimes", ("district", "year"), ("sum", "records")))
    jk = jax.random.fold_in(jax.random.PRNGKey(9), h)
    tk = prng.fold_in(prng.PRNGKey(9), h)
    jks, jke = jax.random.split(jk)
    tks, tke = prng.split(tk)
    np.testing.assert_array_equal(
        prng.uniform(tks, (4097,), device="cpu").numpy(), np.asarray(jax.random.uniform(jks, (4097,))))
    jkb, _ = jax.random.split(jke)
    tkb, _ = prng.split(tke)
    assert (_np(tkb) == _np(jkb)).all()
