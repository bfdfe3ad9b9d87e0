"""The port's ``make_schedule`` against the reference's, on the CPU.

The port draws with its threefry (``core/prng.py``) in the reference's
order, so uniform schedules equal the reference's in every field, bit
for bit, for ``ClusterConfig`` and ``ChainConfig`` with and without an
``entry_node``.  Zipf keys invert a float32 CDF the port builds on the
host in XLA's CPU summation order (``workload.zipf_cdf_f32``); its
powers are float64 rounded to float32, where XLA evaluates its own
float32 ``pow``.  At the key-space sizes below the two CDFs are equal, so
zipf schedules are equal too; a key may differ only where the uniform
draw falls between the two CDFs at a key boundary, and on the
65,536-key space of a 512-lane schedule no lane does (0 of 512).
The CDF recipes the port could use are measured against the reference's
here.  Also the torch forms of ``tests/test_workload.py``'s sampling
tests: bounds and dtype, edge draws clipped, the power law, uniform
coverage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import types as j_types  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from torch_parity import CPU  # noqa: E402


def _configs(kind: str, C: int, K: int):
    chain = dict(n_nodes=4, num_keys=K, num_versions=4)
    if kind == "chain":
        return j_types.ChainConfig(**chain), t_types.ChainConfig(**chain)
    return (j_types.ClusterConfig(chain=j_types.ChainConfig(**chain),
                                  n_chains=C),
            t_types.ClusterConfig(chain=t_types.ChainConfig(**chain),
                                  n_chains=C))


def _schedules(kind, C, K, **wl):
    jcfg, tcfg = _configs(kind, C, K)
    return (j_workload.make_schedule(jcfg, j_workload.WorkloadConfig(**wl)),
            t_workload.make_schedule(tcfg, t_workload.WorkloadConfig(**wl),
                                     device=CPU))


def _assert_fields_equal(exp, got, skip=()):
    for f in got._fields:
        if f in skip:
            continue
        e, g = np.asarray(getattr(exp, f)), convert.to_numpy(getattr(got, f))
        assert g.dtype == e.dtype and g.shape == e.shape, f
        np.testing.assert_array_equal(g, e, err_msg=f)


# one lane shape per chain count: the reference's eager ops compile once
# per shape
T, Q = 8, 16


@pytest.mark.parametrize("kind,C,entry", [
    ("cluster", 2, None), ("cluster", 2, 1), ("chain", 1, None),
    ("chain", 1, 2)])
def test_uniform_schedule_equals_reference_bit_for_bit(kind, C, entry):
    exp, got = _schedules(kind, C, 64, ticks=T, queries_per_tick=Q,
                          write_fraction=0.3, entry_node=entry, seed=9)
    _assert_fields_equal(exp, got)
    assert (convert.to_numpy(got.op) == j_types.OP_WRITE).any()


def _reference_cdf(num_keys, a):
    """The reference's zipf CDF, computed as its ``_sample_keys`` does."""
    ranks = jnp.arange(1, num_keys + 1, dtype=jnp.float32)
    probs = ranks ** (-a)
    probs = probs / probs.sum()
    return np.asarray(jnp.cumsum(probs))


def _candidates(num_keys, a):
    """The CDF recipes the port could use on the host."""
    f64 = np.arange(1, num_keys + 1, dtype=np.float64) ** (-a)
    r = torch.arange(1, num_keys + 1, dtype=torch.float32) ** (-a)
    f32 = np.arange(1, num_keys + 1, dtype=np.float32) ** np.float32(-a)
    return {
        "torch float32": torch.cumsum(r / r.sum(), 0).numpy(),
        "numpy float32": np.cumsum(f32 / f32.sum(dtype=np.float32),
                                   dtype=np.float32),
        "float64, then float32": np.cumsum(f64 / f64.sum()).astype(
            np.float32),
        "zipf_cdf_f32": t_workload.zipf_cdf_f32(num_keys, a),
    }


@pytest.mark.parametrize("num_keys,a", [(6, 1.2), (64, 1.2), (100, 0.5),
                                        (1000, 1.2), (65_536, 1.2),
                                        (57_344, 0.5)])
def test_zipf_cdf_recipe_is_the_closest_to_the_reference(num_keys, a):
    """The port's recipe gives the reference's CDF bit for bit at every
    size here (non-multiples of the summation windows too); the naive
    float32 and float64 recipes differ in most entries at 65,536 keys."""
    ref = _reference_cdf(num_keys, a)
    diffs = {name: int((c != ref).sum())
             for name, c in _candidates(num_keys, a).items()}
    assert diffs["zipf_cdf_f32"] == 0, diffs
    assert diffs["zipf_cdf_f32"] == min(diffs.values()), diffs
    if num_keys == 65_536:
        assert min(v for k, v in diffs.items() if k != "zipf_cdf_f32") > \
            1000, diffs


@pytest.mark.parametrize("kind,C,K,entry", [
    ("cluster", 1, 65_536, None), ("cluster", 2, 64, 2),
    ("chain", 1, 6, None)])
def test_zipf_schedule_differs_only_at_cdf_boundaries(kind, C, K, entry):
    """Every field but ``key`` bit for bit, the uniforms equal, and a key
    differs only where ``u`` lies between the two CDFs at a boundary
    (none here: the CDFs are equal)."""
    q, seed, a = Q, 4, 1.2
    wl = dict(ticks=T, queries_per_tick=q, write_fraction=0.25,
              entry_node=entry, key_skew="zipf", zipf_a=a, seed=seed)
    exp, got = _schedules(kind, C, K, **wl)
    _assert_fields_equal(exp, got, skip=("key",))
    # the raw draws behind the keys
    shape = (T, C, 4, q)
    jk = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
    tk = prng.split(prng.PRNGKey(seed, CPU), 3)[0]
    u_ref = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy(), u_ref)
    jwl = j_workload.WorkloadConfig(**wl)
    k_ref = np.asarray(j_workload._sample_keys(jk, shape, K, jwl))
    k_got = t_workload._sample_keys(tk, shape, K,
                                    t_workload.WorkloadConfig(**wl)).numpy()
    cdf_ref, cdf_got = _reference_cdf(K, a), t_workload.zipf_cdf_f32(K, a)
    differ = np.argwhere(k_ref != k_got)
    for i in map(tuple, differ):
        u = u_ref[i]
        split = (np.minimum(cdf_ref, cdf_got) < u) & (
            u <= np.maximum(cdf_ref, cdf_got))
        assert split.any(), (i, u, k_ref[i], k_got[i])
    assert len(differ) == 0
    np.testing.assert_array_equal(convert.to_numpy(got.key),
                                  np.asarray(exp.key))


def test_make_schedule_has_no_torch_generator():
    """The schedule's randomness is the threefry key of the seed alone."""
    import inspect

    src = inspect.getsource(t_workload.make_schedule) + inspect.getsource(
        t_workload._sample_keys)
    assert "Generator" not in src and "manual_seed" not in src


# -- torch forms of tests/test_workload.py's sampling tests ----------------
def _keys(seed, shape, num_keys, **wl):
    return t_workload._sample_keys(prng.PRNGKey(seed, CPU), shape, num_keys,
                                   t_workload.WorkloadConfig(**wl))


def test_zipf_keys_in_bounds_and_int32():
    keys = _keys(0, (20_000,), 64, key_skew="zipf", zipf_a=1.2)
    assert keys.dtype == torch.int32
    assert int(keys.min()) >= 0 and int(keys.max()) <= 63


def test_zipf_clip_keeps_edge_draws_in_range():
    """u -> 1 lands past the last CDF bucket; the clip keeps the draw on
    the last valid key even for tiny key spaces."""
    for num_keys in (2, 3):
        k = _keys(7, (50_000,), num_keys, key_skew="zipf", zipf_a=0.5)
        assert int(k.min()) >= 0 and int(k.max()) == num_keys - 1


def test_zipf_distribution_matches_power_law():
    a, n_keys, n = 1.2, 64, 200_000
    k = _keys(3, (n,), n_keys, key_skew="zipf", zipf_a=a).numpy()
    freq = np.bincount(k, minlength=n_keys) / n
    assert freq[0] == freq.max()
    assert freq[0] > 5 * freq[16] > 0
    expected = np.arange(1, n_keys + 1, dtype=np.float64) ** (-a)
    expected /= expected.sum()
    np.testing.assert_allclose(freq[:4], expected[:4], rtol=0.1)


def test_uniform_keys_cover_the_space_evenly():
    k = _keys(1, (50_000,), 16, key_skew="uniform").numpy()
    freq = np.bincount(k, minlength=16) / k.size
    assert freq.min() > 0.8 / 16 and freq.max() < 1.25 / 16
