"""repro_torch prefix_partition and filter_tree_lookup against the JAX
reference: on the CPU each wrapper runs its plain twin, which must equal
the reference's Pallas kernel (interpret mode, through ``ops``) and its
numpy oracle (``kernels/ref.py``) bit for bit, at the shapes of
``tests/test_kernels.py`` and at a few ragged and edge cases; the port's
``core.set_count.filter_lookup`` equals the reference's plain
``filter_lookup``; a plain emulation of the card's hash build and probe
(``csrc/set_count.cu``) equals both on duplicate, colliding and extreme
keys and payloads; and ``gather_sources_from_counts`` takes a leading
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


@pytest.mark.parametrize("n,block", [(128, 128), (512, 128), (2048, 512),
                                     (3000, 300), (3072, 1024), (480, 96),
                                     (3000, 1000), (8200, 4100)])
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


def _card_partition(vals, cond, block, threads=256, items=4):
    """csrc/prefix_partition.cu in numpy, CTA by CTA: a tile of threads x
    items elements, each thread's items in a row; a slot's rank from the
    warp ballots (the selected items of earlier lanes, every slot) plus
    the warp totals of earlier warps plus the thread's earlier slots; up
    to a tile of whole blocks a CTA (their bounds' ranks), or a wider
    block walked tile by tile after its selected count, with carried
    counts."""
    tile = threads * items
    out = np.empty_like(vals)
    nsel = np.empty(len(vals) // block, np.int32)

    def ranks(f):
        f = np.pad(f, (0, tile - len(f))).reshape(threads // 32, 32, items)
        lanes = f.sum(2)
        ballot = np.cumsum(lanes, 1) - lanes  # earlier lanes, every slot
        warps = lanes.sum(1)
        pre = (np.cumsum(warps) - warps)[:, None, None] + ballot[..., None] \
            + np.cumsum(f, 2) - f
        return pre.reshape(-1), int(warps.sum())

    nb = len(vals) // block
    if block <= tile:
        per = tile // block
        for b0 in range(0, nb, per):
            k = min(per, nb - b0)
            g, cnt = b0 * block, k * block
            f = cond[g:g + cnt].astype(np.int64)
            pre, total = ranks(f)
            bound = np.append(pre[:cnt:block], total)
            stage = np.empty(cnt, vals.dtype)
            for i in range(cnt):
                kk, start = i // block, i // block * block
                s_ = pre[i] - bound[kk]
                sel = bound[kk + 1] - bound[kk]
                stage[start + (s_ if f[i] else sel + i - start - s_)] = \
                    vals[g + i]
            out[g:g + cnt] = stage
            nsel[b0:b0 + k] = np.diff(bound)
        return out, nsel
    for b in range(nb):
        base = b * block
        n_sel = int(cond[base:base + block].sum())
        done = [0, 0]
        for t0 in range(0, block, tile):
            cnt = min(tile, block - t0)
            f = cond[base + t0:base + t0 + cnt].astype(np.int64)
            pre, total = ranks(f)
            stage = np.empty(cnt, vals.dtype)
            for i in range(cnt):
                stage[pre[i] if f[i] else total + i - pre[i]] = \
                    vals[base + t0 + i]
            for k in range(cnt):
                out[base + (done[0] + k if k < total
                            else n_sel + done[1] + k - total)] = stage[k]
            done = [done[0] + total, done[1] + cnt - total]
        nsel[b] = n_sel
    return out, nsel


@pytest.mark.parametrize("n,block,p", [(128, 128, 0.4), (2048, 512, 0.4),
                                       (3000, 300, 0.5), (480, 96, 0.4),
                                       (3000, 1000, 0.4), (8200, 4100, 0.4),
                                       (4096, 1024, 0.0), (4096, 1024, 1.0),
                                       (2049, 2049, 0.3), (7, 1, 0.5)])
def test_card_partition_emulation_matches_reference(n, block, p):
    """The card's tile schedule and rank formulas (emulated) equal the
    reference's numpy oracle bit for bit, at the tests' blocks and at
    ragged ones (96, 300, 1000, 4100, an odd 2049, 1)."""
    vals, cond = _partition_inputs(n, seed=n + block, p=p)
    got, nsel = _card_partition(vals, cond, block)
    want, want_n = ref.prefix_partition_ref(vals, cond, block)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nsel, want_n)


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


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _wrap(x):
    """int32 wrap-around of a Python int."""
    return (x + 2**31) % 2**32 - 2**31


def _hash_filter_emulated(keys, pays, tgts):
    """The card's filter, one key and one target at a time: a table of
    2^bits (key, enc) slots filled with -1, keys inserted by linear probing
    from the first slot of their ``filter_hash`` group with a max of
    payload + 1 (the empty key -1 in the slot after the table), targets
    probed until their key or an empty slot, a target INT32_MIN raised to
    enc 1 when the key count is ragged (the twin's INT32_MIN padding)."""
    e = len(keys)
    bits = tsc.filter_table_bits(e)
    n = 1 << bits
    g = tsc.FILTER_GROUP_LOG2
    assert tsc.filter_scratch(e, "cpu").numel() == 2 * (n + 1)
    slot_key, slot_enc = [-1] * n, [-1] * (n + 1)
    first = (tsc.filter_hash(torch.from_numpy(np.asarray(keys, np.int32)),
                             bits - g) << g).tolist()
    for k, p, s in zip(keys.tolist(), pays.tolist(), first):
        if k == tsc.FILTER_EMPTY:
            s = n
        else:
            while slot_key[s] not in (tsc.FILTER_EMPTY, k):
                s = (s + 1) % n
            slot_key[s] = k
        slot_enc[s] = max(slot_enc[s], _wrap(p + 1))
    out, hit = [], []
    first = (tsc.filter_hash(torch.from_numpy(np.asarray(tgts, np.int32)),
                             bits - g) << g).tolist()
    for t, s in zip(tgts.tolist(), first):
        if t == tsc.FILTER_EMPTY:
            enc = slot_enc[n]
        else:
            while slot_key[s] not in (tsc.FILTER_EMPTY, t):
                s = (s + 1) % n
            enc = slot_enc[s] if slot_key[s] == t else -1
        if e % 2048 and t == INT32_MIN:
            enc = max(enc, 1)
        out.append(enc - 1 if enc > 0 else -1)
        hit.append(enc > 0)
    return np.array(out, np.int32), np.array(hit)


def _colliding_keys(e, seed):
    """``e`` distinct keys whose group is 0 in the table for ``e`` keys:
    every insert and probe walks the same run."""
    bits = tsc.filter_table_bits(e) - tsc.FILTER_GROUP_LOG2
    cand = torch.arange(1, 1 << (bits + 12), dtype=torch.int64)
    same = cand[tsc.filter_hash(cand, bits) == 0][:e]
    assert same.numel() == e
    return np.random.default_rng(seed).permutation(same.numpy()).astype(
        np.int32)


def _filter_case(kind, e, seed):
    """(keys, payloads, targets) of one emulation case: a quarter of the
    targets hit, and INT32_MIN, -1 and INT32_MAX are among the targets."""
    rng = np.random.default_rng(seed)
    if kind == "collide":
        keys = _colliding_keys(e, seed)
    elif kind == "duplicates":
        keys = rng.integers(0, max(1, e // 4), e).astype(np.int32)
    else:
        keys = rng.permutation(10 * e + 10)[:e].astype(np.int32)
    if kind == "extreme_keys" and e:
        keys[rng.permutation(e)[:3]] = [INT32_MIN, -1, INT32_MAX][:min(3, e)]
    pays = rng.integers(-5, 1 << 30, e).astype(np.int32)
    if e:
        pays[rng.integers(0, e, max(1, e // 8))] = INT32_MAX  # wraps: a miss
        pays[rng.integers(0, e, max(1, e // 8))] = -5
    t = 300
    tgts = rng.integers(-10, 10 * e + 20, t).astype(np.int32)
    if e:
        tgts[: t // 4] = keys[rng.integers(0, e, t // 4)]
    tgts[-3:] = [INT32_MIN, -1, INT32_MAX]
    return keys, pays, tgts


def _reference_kernel(keys, pays, tgts):
    """The reference's Pallas filter (interpret mode) on the keys padded
    to its 2048 block (INT32_MIN, payload 0) and the targets to its 256."""
    e, t = len(keys), len(tgts)
    size, tsize = e + (-e) % 2048, t + (-t) % 256
    k = np.full(size, INT32_MIN, np.int32)
    p = np.zeros(size, np.int32)
    k[:e], p[:e] = keys, pays
    tg = np.zeros(tsize, np.int32)
    tg[:t] = tgts
    jp, jh = ops.filter_tree_lookup(jnp.asarray(k), jnp.asarray(p),
                                    jnp.asarray(tg))
    return np.asarray(jp)[:t], np.asarray(jh)[:t]


@pytest.mark.parametrize("kind,e", [
    ("unique", 1), ("unique", 2048), ("unique", 3000), ("unique", 0),
    ("duplicates", 3000), ("duplicates", 2048), ("collide", 64),
    ("collide", 2048), ("extreme_keys", 3000), ("extreme_keys", 2048),
    ("extreme_keys", 1)])
def test_filter_hash_emulation_matches_reference_and_twin(kind, e):
    """The card's algorithm, emulated one key and one target at a time,
    equals the twin and the reference's kernel (its plain ``filter_lookup``
    where E = 0 gives the kernel no block) bit for bit: duplicate keys (max
    payload), keys that all start at one slot, INT32_MIN / -1 / INT32_MAX
    keys and targets, payloads INT32_MAX (a miss) and -5, ragged and whole
    key blocks."""
    keys, pays, tgts = _filter_case(kind, e, seed=e + len(kind))
    got = _hash_filter_emulated(keys, pays, tgts)
    twin = tsc.filter_tree_lookup(*map(torch.from_numpy, (keys, pays, tgts)))
    if e:
        want = _reference_kernel(keys, pays, tgts)
    else:
        want = j_filter_lookup(jnp.asarray(keys), jnp.asarray(pays),
                               jnp.asarray(tgts))
    for g, tw, w in zip(got, twin, want):
        np.testing.assert_array_equal(g, tw.numpy())
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (int(got[1].sum()) > 0) == (e > 0)


def test_filter_mirrors_the_kernel_source():
    """The Python mirrors of the hash, the table size and the empty key
    are the ones csrc/set_count.cu uses."""
    import pathlib
    src = (pathlib.Path(tsc.__file__).parents[1] / "csrc" / "set_count.cu"
           ).read_text()
    assert f"0x{tsc.FILTER_HASH_MUL:X}u" in src
    assert f"kFilterEmpty = {tsc.FILTER_EMPTY};" in src
    assert "(1LL << bits) < 2LL * n_keys" in src
    assert f"kGroupLog2 = {tsc.FILTER_GROUP_LOG2};" in src
    for e in (0, 1, 2, 3, 4, 5, 1000, 2048, 282_624):
        bits = tsc.filter_table_bits(e)
        assert bits >= 3 and (1 << bits) >= 2 * e
        assert bits == 3 or (1 << (bits - 1)) < 2 * e
    # the top bits of key * 0x9E3779B1 mod 2^32
    k = torch.tensor([0, 1, -1, INT32_MIN, INT32_MAX], dtype=torch.int32)
    want = [((x % 2**32) * 0x9E3779B1 % 2**32) >> 20 for x in k.tolist()]
    assert tsc.filter_hash(k, 12).tolist() == want
