"""repro_torch.core.prng: threefry-2x32 keys and uniform draws bit-equal
to jax.random (jax_threefry_partitionable=True) — the precondition for a
sampled subgraph, and the serve path's fold_in(base_key, rid) keys, to
match the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def _jkey(k):
    return jnp.asarray(np.array(k, dtype=np.uint32))


def test_partitionable_threefry_is_the_reference_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prngkey_matches(seed):
    assert prng.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 2, 999, 2**31 - 1, 2**32 - 1])
def test_fold_in_matches(data):
    for seed in (0, 3):
        assert (prng.fold_in(prng.PRNGKey(seed), data)
                == _key(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches(num):
    key = prng.fold_in(prng.PRNGKey(11), 4)
    want = [_key(k) for k in jax.random.split(_jkey(key), num)]
    assert prng.split(key, num) == want


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (3, 5), (1000,),
                                   (4, 2, 3)])
def test_uniform_bit_equal(shape):
    key = prng.fold_in(prng.PRNGKey(5), 17)
    got = prng.uniform(key, shape, "cpu").numpy()
    want = np.asarray(jax.random.uniform(_jkey(key), shape))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_rows_equal_per_key_draws():
    keys = prng.split(prng.PRNGKey(9), 4)
    rows = prng.uniform_rows(keys, 33, "cpu").numpy()
    for i, k in enumerate(keys):
        want = np.asarray(jax.random.uniform(_jkey(k), (33,)))
        np.testing.assert_array_equal(rows[i].view(np.int32),
                                      want.view(np.int32))


def test_floyd_key_schedule_matches_reference_draws():
    """The sampler's schedule: fold_in per layer, then one split per step
    whose second half draws the step's uniforms."""
    key = prng.fold_in(prng.PRNGKey(0), 3)
    jk = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    for layer in range(2):
        k, jkl = prng.fold_in(key, layer), jax.random.fold_in(jk, layer)
        for _ in range(3):
            k, sub = prng.split(k)
            jkl, jsub = jax.random.split(jkl)
            np.testing.assert_array_equal(
                prng.uniform(sub, (50,), "cpu").numpy(),
                np.asarray(jax.random.uniform(jsub, (50,))))


@pytest.mark.parametrize("fanouts", [(3, 2), (4,), (25, 10)])
def test_key_schedule_matches_reference_chain(fanouts):
    """key_schedule's rows are the sub-keys of the reference sampler's
    chain, bit for bit: fold_in(key, layer), then one split per step."""
    key = prng.fold_in(prng.PRNGKey(2), 41)
    jk = jax.random.fold_in(jax.random.PRNGKey(2), 41)
    want = []
    for layer, k in enumerate(fanouts):
        jkl = jax.random.fold_in(jk, layer)
        for _ in range(k):
            jkl, jsub = jax.random.split(jkl)
            want.append(_key(jsub))
    got = prng.key_schedule(key, fanouts)
    assert got.dtype == torch.int64 and tuple(got.shape) == (sum(fanouts), 2)
    assert [tuple(r) for r in got.tolist()] == want


def test_uniform_rows_from_a_schedule_table_equal_the_tuple_path():
    """A [K, 2] int64 table draws what the same keys as tuples draw, on
    the table's device, and what jax.random.uniform draws."""
    fanouts = (3, 2)
    key = prng.fold_in(prng.PRNGKey(9), 5)
    table = prng.key_schedule(key, fanouts)
    keys = [tuple(r) for r in table.tolist()]
    got = prng.uniform_rows(table, 57, "meta").numpy()  # device: the table's
    want = prng.uniform_rows(keys, 57, "cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got[4].view(np.int32),
        np.asarray(jax.random.uniform(_jkey(keys[4]), (57,))).view(np.int32))
