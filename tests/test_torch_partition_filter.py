"""repro_torch prefix_partition and filter_tree_lookup against the JAX
reference: on the CPU each wrapper runs its plain twin, which must equal
the reference's Pallas kernel (interpret mode, through ``ops``) and its
numpy oracle (``kernels/ref.py``) bit for bit, at the shapes of
``tests/test_kernels.py`` and at a few ragged and edge cases; the port's
``core.set_count.filter_lookup`` equals the reference's plain
``filter_lookup``; and ``gather_sources_from_counts`` takes a leading
batch axis as a stack of independent partitions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.set_count import filter_lookup as j_filter_lookup  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro_torch.core.set_count import filter_lookup  # noqa: E402
from repro_torch.core.set_partition import gather_sources_from_counts  # noqa: E402
from repro_torch.kernels import prefix_partition as tpp  # noqa: E402
from repro_torch.kernels import set_count as tsc  # noqa: E402


def _partition_inputs(n, seed, p=0.4):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    return vals, rng.random(n) < p


@pytest.mark.parametrize("n,block", [(128, 128), (512, 128), (2048, 512)])
def test_prefix_partition_twin_matches_reference(n, block):
    vals, cond = _partition_inputs(n, seed=1)
    got, nsel = tpp.prefix_partition(torch.from_numpy(vals),
                                     torch.from_numpy(cond), block=block)
    jgot, jn = ops.prefix_partition(jnp.asarray(vals), jnp.asarray(cond),
                                    block=block)
    want, want_n = ref.prefix_partition_ref(vals, cond, block)
    for g, w in ((got, jgot), (got, want), (nsel, jn), (nsel, want_n)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.dtype == torch.int32 and nsel.dtype == torch.int32


@pytest.mark.parametrize("p", [0.0, 1.0, 0.02])
def test_prefix_partition_edge_fractions(p):
    """No element, every element and almost no element selected."""
    vals, cond = _partition_inputs(3072, seed=2, p=p)
    got, nsel = tpp.prefix_partition(torch.from_numpy(vals),
                                     torch.from_numpy(cond), block=1024)
    want, want_n = ref.prefix_partition_ref(vals, cond, 1024)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nsel.numpy(), want_n)


def test_prefix_partition_refuses_ragged_blocks():
    vals, cond = _partition_inputs(100, seed=3)
    with pytest.raises(ValueError, match="multiple of block"):
        tpp.prefix_partition(torch.from_numpy(vals), torch.from_numpy(cond),
                             block=64)


def _filter_inputs(e, t, seed):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(10 * e)[:e].astype(np.int32)
    pays = np.arange(e, dtype=np.int32)
    tgts = rng.integers(0, 10 * e, t).astype(np.int32)
    tgts[: t // 4] = keys[rng.integers(0, e, t // 4)]  # a quarter hit
    return keys, pays, tgts


@pytest.mark.parametrize("e,t", [(2048, 256), (4096, 128)])
def test_filter_tree_lookup_twin_matches_reference(e, t):
    keys, pays, tgts = _filter_inputs(e, t, seed=6)
    got_p, got_h = tsc.filter_tree_lookup(*map(torch.from_numpy,
                                               (keys, pays, tgts)))
    jp, jh = ops.filter_tree_lookup(jnp.asarray(keys), jnp.asarray(pays),
                                    jnp.asarray(tgts), t_block=128,
                                    e_block=1024)
    want_p, want_h = ref.filter_tree_lookup_ref(keys, pays, tgts)
    for g, w in ((got_p, jp), (got_p, want_p), (got_h, jh), (got_h, want_h)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got_p.dtype == torch.int32 and got_h.dtype == torch.bool
    assert 0 < int(got_h.sum()) < t


@pytest.mark.parametrize("e,t", [(3000, 300), (1, 5), (5000, 1)])
def test_filter_lookup_matches_reference_plain(e, t):
    """Ragged key counts (padded to the 2048 block with INT32_MIN) and
    payloads that are not positions."""
    keys, _, tgts = _filter_inputs(e, t, seed=e + t)
    pays = np.random.default_rng(e).integers(0, 1 << 30, e).astype(np.int32)
    got = filter_lookup(*map(torch.from_numpy, (keys, pays, tgts)))
    want = j_filter_lookup(jnp.asarray(keys), jnp.asarray(pays),
                           jnp.asarray(tgts))
    oracle = ref.filter_tree_lookup_ref(keys, pays, tgts)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)


def test_batched_router_equals_per_partition_router():
    rng = np.random.default_rng(9)
    c = torch.from_numpy((rng.random((5, 64)) < 0.3).astype(np.int32))
    incl = torch.stack([torch.cumsum(c, 1, dtype=torch.int32),
                        torch.cumsum(1 - c, 1, dtype=torch.int32)], dim=2)
    base = torch.stack([torch.zeros(5, dtype=torch.int32), incl[:, -1, 0]],
                       dim=1)
    got = gather_sources_from_counts(incl, base)
    for i in range(5):
        assert torch.equal(got[i], gather_sources_from_counts(incl[i],
                                                              base[i]))
