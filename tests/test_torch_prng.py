"""The port's threefry draws (``repro_torch.net.prng``) against
``jax.random`` on the CPU: ``PRNGKey``, ``split``, ``uniform`` and
``randint`` must be equal bit for bit (tolerance: exact, the float32
draws compared as bit patterns), for single keys, chains of splits and a
batch of keys against a vmapped JAX call."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.net import prng  # noqa: E402

SEEDS = [0, 1, 7, 11, 2**31 - 1]
SIZES = [1, 2, 3, 64, 128, 1000, 4096]


def tkey(jkey):
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


def assert_bits_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_jax_default_is_partitionable_threefry():
    """The port follows the partitionable counter layout; a change of
    JAX's default would change every stream."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    got = prng.PRNGKey(seed, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [-1, -5, 2**32 + 5, 2**33 - 3])
def test_prngkey_takes_the_low_32_bits(seed):
    """With 64-bit mode off JAX takes a seed as 32 bits: the high word is 0
    for a negative seed, and a seed past 2**32 wraps."""
    np.testing.assert_array_equal(prng.PRNGKey(seed, device="cpu").numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 4, 5, 8])
@pytest.mark.parametrize("seed", [0, 11])
def test_split(seed, num):
    jk = jax.random.PRNGKey(seed)
    assert_bits_equal(prng.split(tkey(jk), num),
                      np.asarray(jax.random.split(jk, num)).astype(np.int64))


def test_split_chains():
    """The fabric's key chain: ``key, sub = split(key)`` per tick, then
    ``split(sub, n)`` and a link's ``split(k, 4)``."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5, device="cpu")
    for step in range(20):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))
        jn = jax.random.split(jsub, 3 + step % 4)
        tn = prng.split(tsub, 3 + step % 4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(
            prng.split(tn[-1], 4).numpy(),
            np.asarray(jax.random.split(jn[-1], 4)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("size", SIZES)
def test_uniform(size):
    for seed in (0, 11):
        jk = jax.random.PRNGKey(seed)
        got = prng.uniform(tkey(jk), (size,))
        assert got.dtype == torch.float32
        assert_bits_equal(got, jax.random.uniform(jk, (size,)))
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("size", SIZES)
def test_randint(size):
    jk = jax.random.PRNGKey(3)
    for hi in list(range(1, 8)) + [2**20]:
        got = prng.randint(tkey(jk), (size,), 0, hi)
        assert got.dtype == torch.int32
        assert_bits_equal(got, jax.random.randint(jk, (size,), 0, hi))


def test_randint_spans_that_wrap_u32():
    """Spans whose multiplier or products wrap in u32 arithmetic, negative
    bounds, and an empty range (JAX returns ``minval``)."""
    jk = jax.random.PRNGKey(9)
    for lo, hi in [(0, 2**31 - 1), (0, 65537), (0, 46341), (-5, 3),
                   (5, 3), (-2**31, 2**31 - 1)]:
        assert_bits_equal(prng.randint(tkey(jk), (257,), lo, hi),
                          jax.random.randint(jk, (257,), lo, hi))


def test_multidimensional_shapes():
    jk = jax.random.PRNGKey(2)
    assert_bits_equal(prng.uniform(tkey(jk), (4, 5, 3)),
                      jax.random.uniform(jk, (4, 5, 3)))
    assert_bits_equal(prng.randint(tkey(jk), (6, 7), 0, 5),
                      jax.random.randint(jk, (6, 7), 0, 5))


@pytest.mark.parametrize("n_keys", [1, 2, 5, 8])
def test_batch_of_keys_equals_vmapped_jax(n_keys):
    """A (N, 2) batch of keys draws as ``jax.vmap`` over the keys does -
    the fabric's one push for all links."""
    jks = jax.random.split(jax.random.PRNGKey(17), n_keys)
    tks = tkey(jks)
    for size in (1, 16, 64):
        assert_bits_equal(
            prng.uniform(tks, (size,)),
            jax.vmap(lambda k: jax.random.uniform(k, (size,)))(jks))
        assert_bits_equal(
            prng.randint(tks, (size,), 0, 3),
            jax.vmap(lambda k: jax.random.randint(k, (size,), 0, 3))(jks))
    np.testing.assert_array_equal(
        prng.split(tks, 4).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 4))(jks)))
