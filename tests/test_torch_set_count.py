"""repro_torch set-count against the JAX reference: the set_count_less twin
(count_less_than) against the reference's set_count_less kernel in Pallas
interpret mode on unsorted, ragged and INT32_MAX-padded input, the
count_fn adapter against pallas_count_fn, and convert under the merge
configuration (chunked_merge sorts through the chunk-sort and fused-merge
kernels, the unfused set-count pointer build) bit-identical to the
reference's convert under the same configuration and to the xla_sort
strategy, packed and two-pass."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import COO, EngineConfig, convert, random_coo  # noqa: E402
from repro.core.set_count import count_less_than as j_count  # noqa: E402
from repro.kernels.set_count import pallas_count_fn  # noqa: E402
from repro.kernels.set_count import set_count_less as j_set_count  # noqa: E402
from repro_torch.core import costmodel as tcm  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core.set_count import count_less_than  # noqa: E402
from repro_torch.kernels import set_count as tsc  # noqa: E402
from repro_torch.launch.serve import MERGE_CFG  # noqa: E402

SEN = 0x7FFFFFFF


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _elems_targets(e, t, seed, pad=0):
    """Unsorted elements (with an INT32_MAX-padded tail of ``pad``) and
    unsorted targets, both with values on either side of each other."""
    rng = np.random.default_rng(seed)
    elems = rng.integers(-50, 5000, e).astype(np.int32)
    if pad:
        elems[-pad:] = SEN
    tgts = rng.integers(-60, 5100, t).astype(np.int32)
    tgts[:3] = np.array([SEN, -2**31, 0], np.int32)[:t]
    return elems, tgts


# (E, T, e_block, t_block, INT32_MAX tail)
KERNEL_CASES = [(2048, 256, 2048, 256, 0), (4096, 512, 1024, 128, 700),
                (1024, 128, 256, 128, 1024)]


@pytest.mark.parametrize("e,t,eb,tb,pad", KERNEL_CASES)
def test_set_count_twin_matches_reference_kernel(e, t, eb, tb, pad):
    elems, tgts = _elems_targets(e, t, seed=e + t, pad=pad)
    want = j_set_count(jnp.asarray(elems), jnp.asarray(tgts), t_block=tb,
                       e_block=eb)
    got = tsc.set_count_less(_t(elems), _t(tgts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), (elems[None, :] < tgts[:, None]).sum(1))


@pytest.mark.parametrize("e,t", [(1000, 300), (7, 1), (2049, 257)])
def test_count_fn_matches_reference_adapter_on_ragged_input(e, t):
    """Ragged sizes go through the adapters' padding on both sides."""
    elems, tgts = _elems_targets(e, t, seed=e)
    want = pallas_count_fn(jnp.asarray(elems), jnp.asarray(tgts))
    np.testing.assert_array_equal(tsc.count_fn(_t(elems), _t(tgts)).numpy(),
                                  np.asarray(want))
    for block in (64, 2048):  # the plain compare-reduce at any block
        np.testing.assert_array_equal(
            count_less_than(_t(elems), _t(tgts), block=block).numpy(),
            np.asarray(j_count(jnp.asarray(elems), jnp.asarray(tgts),
                               block=block)))


GRAPHS = [(120, 900, 1024), (32768, 1500, 2048)]
MERGE_KW = dict(w_upe=256, use_pallas=True, sort_strategy="chunked_merge",
                reindex_strategy="unfused")


@pytest.fixture(scope="module")
def j_converts():
    """The reference's convert under the merge configuration (its Pallas
    chunk-sort, merge and set-count kernels in interpret mode)."""
    out = {}
    for n, e, cap in GRAPHS:
        dst, src = random_coo(np.random.default_rng(n), n, e)
        out[n] = convert(COO.from_arrays(dst, src, n, capacity=cap),
                         EngineConfig(**MERGE_KW))
    return out


@pytest.mark.parametrize("n,e,cap", GRAPHS)
def test_convert_merge_cfg_matches_reference(j_converts, n, e, cap):
    dst, src = random_coo(np.random.default_rng(n), n, e)
    tc = tg.COO.from_arrays(dst, src, n, capacity=cap, device="cpu")
    ref = j_converts[n]
    csc = tp.convert(tc, tcm.EngineConfig(**MERGE_KW), device="cpu")
    xla = tp.convert(tc, tcm.EngineConfig(sort_strategy="xla_sort"),
                     device="cpu")
    for got, want in ((csc.ptr, ref.ptr), (csc.idx, ref.idx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(csc.ptr.numpy(), xla.ptr.numpy())
    np.testing.assert_array_equal(csc.idx.numpy(), xla.idx.numpy())


def test_merge_cfg_routes_all_six_kernel_fns():
    """MERGE_CFG resolves to the path it names, and ``kernel_fns`` gives
    the reference's six routes under use_pallas (none without)."""
    kf = tp.kernel_fns(MERGE_CFG)
    assert len(kf) == 6 and all(fn is not None for fn in kf)
    assert kf.count_fn is tsc.count_fn
    assert tp.kernel_fns(tcm.EngineConfig()) == (None,) * 6
    w = tcm.Workload(n=282_624, e=1 << 19)
    assert tcm.resolve_sort_strategy(MERGE_CFG, w) == "chunked_merge"
    assert tcm.pointer_reindex_strategy(MERGE_CFG, w) == "unfused"


def test_explicit_count_fn_overrides_routing():
    """``convert(count_fn=...)`` takes precedence over the config's
    routing (the reference's override), with the same CSC."""
    dst, src = random_coo(np.random.default_rng(5), 100, 1500)
    tc = tg.COO.from_arrays(dst, src, 100, capacity=2048, device="cpu")
    calls = []

    def spy(sorted_dst, targets):
        calls.append(targets.shape[0])
        return tsc.count_fn(sorted_dst, targets)

    cfg = tcm.EngineConfig(w_upe=256, reindex_strategy="unfused")
    got = tp.convert(tc, cfg, device="cpu", count_fn=spy)
    want = tp.convert(tc, cfg, device="cpu")
    assert calls == [101]
    np.testing.assert_array_equal(got.ptr.numpy(), want.ptr.numpy())
    np.testing.assert_array_equal(got.idx.numpy(), want.idx.numpy())
