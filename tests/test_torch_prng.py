"""The port's threefry PRNG (``repro_torch.core.prng``) against the
installed ``jax.random``: keys, folds, splits, uniform floats and
integers, bit for bit, over extreme seeds, large fold-in data and the
shapes the load generator draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402

CPU = "cpu"
SEEDS = (0, 1, 7, 2**31 - 1, -1, -2**31)
FOLDS = (0, 3, 7919, 123_456, 2**31 - 1, -1, -2**31)
SHAPES = ((1,), (7,), (4096,), (3, 5))
SPANS = ((1, 1 << 20), (0, 10), (-5, 3), (0, 1 << 16), (0, (1 << 16) + 1),
         (-2**31, 2**31 - 1), (3, 3), (5, 2))


def _key(seed):
    return jax.random.PRNGKey(jnp.asarray(seed, jnp.int32))


def _words(jkey) -> np.ndarray:
    return np.asarray(jkey).astype(np.int64)


def test_jax_runs_the_configuration_the_port_reproduces():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_folds_and_splits_match_jax(seed):
    jk, tk = _key(seed), prng.PRNGKey(seed, device=CPU)
    assert tk.dtype == torch.int64 and tk.shape == (2,)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    np.testing.assert_array_equal(
        prng.PRNGKey(torch.tensor(seed, dtype=torch.int32)).numpy(),
        _words(jk))
    for d in FOLDS:
        np.testing.assert_array_equal(
            prng.fold_in(tk, d).numpy(),
            _words(jax.random.fold_in(jk, jnp.asarray(d, jnp.int32))))
    # fold_in over a tensor of data, and a batch of keys
    data = torch.tensor(FOLDS, dtype=torch.int32)
    folded = prng.fold_in(tk, data)
    for i, d in enumerate(FOLDS):
        np.testing.assert_array_equal(
            folded[i].numpy(),
            _words(jax.random.fold_in(jk, jnp.asarray(d, jnp.int32))))
    for num in (2, 4, 5):
        split = prng.split(tk, num)
        np.testing.assert_array_equal(split.numpy(),
                                      _words(jax.random.split(jk, num)))
        # split(key, n)[i] is fold_in(key, i), which the generator uses
        np.testing.assert_array_equal(
            split.numpy(), prng.fold_in(tk[None], torch.arange(num)).numpy())
    nested = prng.split(prng.split(tk, 3), 2)
    for i, sub in enumerate(jax.random.split(jk, 3)):
        np.testing.assert_array_equal(nested[i].numpy(),
                                      _words(jax.random.split(sub, 2)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    jk = jax.random.fold_in(_key(seed), 11)
    tk = prng.fold_in(prng.PRNGKey(seed, device=CPU), 11)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(tk, shape).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_matches_jax_over_spans(seed, shape):
    jk = jax.random.fold_in(_key(seed), 5)
    tk = prng.fold_in(prng.PRNGKey(seed, device=CPU), 5)
    for lo, hi in SPANS:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))
        got = prng.randint(tk, shape, lo, hi).numpy()
        assert got.dtype == np.int32, got.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"[{lo}, {hi})")


def test_random_bits_match_jax_for_a_batch_of_keys():
    """A batch of keys draws each key's own stream of 32-bit words."""
    keys = prng.split(prng.PRNGKey(3, device=CPU), 4)
    bits = prng.random_bits(keys, (2, 9))
    assert bits.shape == (4, 2, 9)
    jkeys = jax.random.split(_key(3), 4)
    for i in range(4):
        want = np.asarray(jax.random.bits(jkeys[i], (2, 9), jnp.uint32))
        np.testing.assert_array_equal(bits[i].numpy(), want.astype(np.int64))


def test_bounds_outside_int32_are_refused():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31, device=CPU)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0, device=CPU), (3,), 0, 2**31)
