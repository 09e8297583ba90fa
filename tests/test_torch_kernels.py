"""The port's kernel entry points (``repro_torch.kernels``) on the CPU, where
they run their plain PyTorch versions, against the reference Pallas kernels
(``repro.kernels``, interpret mode) on the same numpy inputs.

Keys and masks must be equal exactly.  The sorts' payloads are checked as
permutations consistent with the keys (the reference's bitonic network is
unstable); the port's payload is also checked against a stable argsort,
which its (key, position) order equals.  The reference kernels take int16
and int32 keys; int64, which they cannot take without x64 jax, is held
against numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RK
from repro_torch.kernels import bitonic_sort as BS
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR

REF_DTYPES = [np.int16, np.int32]
ALL_DTYPES = [np.int16, np.int32, np.int64]


def pad(dt) -> int:
    return int(np.iinfo(dt).max)


def rand(rng, n, dt, hi=1 << 20):
    return rng.integers(0, min(hi, pad(dt)), n).astype(dt)


def check_sort(keys: np.ndarray, tile: int = 1024):
    n = len(keys)
    vals = np.arange(n, dtype=np.int32)
    ks, vs = TK.sort_with_payload(torch.from_numpy(keys),
                                  torch.from_numpy(vals), tile=tile)
    ks, vs = ks.numpy(), vs.numpy()
    np.testing.assert_array_equal(ks, np.sort(keys))
    np.testing.assert_array_equal(vs, np.argsort(keys, kind="stable"))
    if keys.dtype in REF_DTYPES:
        rk, rv = RK.sort_with_payload(jnp.asarray(keys), jnp.asarray(vals),
                                      tile=tile)
        np.testing.assert_array_equal(ks, np.asarray(rk))
        rv = np.asarray(rv)
        assert sorted(rv.tolist()) == list(range(n))
        np.testing.assert_array_equal(keys[rv], ks)


@pytest.mark.parametrize("dt", ALL_DTYPES)
@pytest.mark.parametrize("n,tile", [(64, 64), (256, 64), (1024, 256),
                                    (2048, 512)])
def test_sort_sweep(n, tile, dt):
    check_sort(rand(np.random.default_rng(n + tile), n, dt), tile)


@pytest.mark.parametrize("dt", ALL_DTYPES)
@pytest.mark.parametrize("n", [1, 3, 96, 300, 1000])
def test_sort_non_pow2_with_pad_keys(n, dt):
    keys = rand(np.random.default_rng(n), n, dt, hi=50)
    keys[::3] = pad(dt)
    check_sort(keys, tile=64)


@pytest.mark.parametrize("dt", ALL_DTYPES)
@pytest.mark.parametrize("n", [64, 100])
def test_sort_all_pad_and_duplicates(n, dt):
    check_sort(np.full(n, pad(dt), dt))
    check_sort(np.full(n, 7, dt), tile=32)


def test_sort_empty():
    ks, vs = TK.sort_with_payload(torch.zeros(0, dtype=torch.int32),
                                  torch.zeros(0, dtype=torch.int32))
    assert ks.shape == (0,) and vs.shape == (0,)


def test_sort_payload_is_a_permutation_of_the_callers():
    """Non-pow-2 padding sorts positions; the caller's payload, whatever its
    values, comes back permuted (regression of keys=[5, PAD, 7])."""
    keys = np.array([5, pad(np.int32), 7], np.int32)
    vals = torch.tensor([10, 20, 30], dtype=torch.int64)
    ks, vs = TK.sort_with_payload(torch.from_numpy(keys), vals)
    np.testing.assert_array_equal(ks.numpy(), [5, 7, pad(np.int32)])
    np.testing.assert_array_equal(vs.numpy(), [10, 30, 20])


@pytest.mark.parametrize("dt", REF_DTYPES)
@pytest.mark.parametrize("n,tile", [(256, 64), (1024, 1024)])
def test_tile_and_merge_wrappers_match_reference(n, tile, dt):
    """The per-kernel wrappers: tiles sorted, then one merge to 2*tile."""
    from repro.kernels import bitonic_sort as RB
    rng = np.random.default_rng(7)
    keys = rand(rng, n, dt, hi=100)
    vals = np.arange(n, dtype=np.int32)
    ks, vs = BS.bitonic_sort_tiles(torch.from_numpy(keys),
                                   torch.from_numpy(vals), tile)
    rk, _ = RB.bitonic_sort_tiles(jnp.asarray(keys), jnp.asarray(vals), tile)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(keys[vs.numpy()], ks.numpy())
    width = min(2 * tile, n)
    if width > tile:
        mk, mv = BS.bitonic_merge_pairs(ks, vs, width)
        rm, _ = RB.bitonic_merge_pairs(rk, jnp.asarray(vs.numpy()), width)
        np.testing.assert_array_equal(mk.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(keys[mv.numpy()], mk.numpy())


def lexsorted(rng, n, c, dt, hi, n_pad=0):
    data = rng.integers(0, hi, (n, c)).astype(dt)
    data = data[np.lexsort(data.T[::-1])]
    if n_pad:
        data[-n_pad:] = pad(dt)
    return data


def numpy_unique_mask(data):
    neq = np.ones(len(data), bool)
    neq[1:] = np.any(data[1:] != data[:-1], axis=1)
    return (neq & (data[:, 0] != pad(data.dtype))).astype(np.int32)


@pytest.mark.parametrize("dt", ALL_DTYPES)
@pytest.mark.parametrize("n,c", [(1, 1), (96, 2), (128, 1), (256, 2),
                                 (300, 3), (512, 3)])
def test_unique_mask(n, c, dt):
    rng = np.random.default_rng(n * c)
    data = lexsorted(rng, n, c, dt, 7, n_pad=n // 5)
    got = TK.unique_mask(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, numpy_unique_mask(data))
    if dt in REF_DTYPES:
        want = RK.unique_mask(jnp.asarray(data))
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("dt", ALL_DTYPES)
def test_unique_mask_edges(dt):
    assert TK.unique_mask(torch.zeros((0, 2), dtype=torch.int32)).shape == (0,)
    allpad = torch.full((128, 2), pad(dt), dtype=getattr(torch, dt.__name__))
    assert (TK.unique_mask(allpad) == 0).all()
    dups = torch.tensor([[3, 4]] * 256, dtype=getattr(torch, dt.__name__))
    got = TK.unique_mask(dups)
    assert int(got.sum()) == 1 and int(got[0]) == 1


def test_unique_mask_ref_uses_the_dtype_pad():
    """The reference oracle compares int16 rows against the int32 PAD and
    so counts int16 PAD rows as valid; the port's plain version does not,
    and agrees with the reference Pallas kernel."""
    data = np.array([[1, 2], [1, 2], [pad(np.int16)] * 2], np.int16)
    got = TR.unique_mask_ref(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, [1, 0, 0])
    np.testing.assert_array_equal(got, np.asarray(
        RK.unique_mask(jnp.asarray(data))))


def probe_case(rng, kind, nq, nh, dt):
    """(queries, sorted haystack) of one probe case.  "unique": distinct
    keys, every 7th query PAD; "distinct": the same with exactly nh keys;
    "runs": runs of one key, the longest over
    the middle of the haystack (the root of the card's search table) and
    others wherever the rounding puts them; "pad_tail": a third of the
    haystack PAD, every 7th query PAD; "all_pad": the haystack all PAD;
    "below" / "above": every query below the first key / above the last."""
    p = pad(dt)
    if kind == "all_pad":
        hay = np.full(nh, p, dt)
    elif kind == "runs":
        hay = np.sort(rng.integers(0, 8, nh)).astype(dt)
        hay[nh // 2 - nh // 8: nh // 2 + nh // 8 + 1] = 9
        hay = np.sort(hay)
    elif kind == "distinct":
        hay = np.sort(rng.choice(4 * nh, nh, replace=False)).astype(dt)
    else:
        hay = np.sort(rand(rng, nh, dt, hi=4 * nh))
        if kind == "unique":
            hay = np.unique(hay)
        if kind == "pad_tail":
            hay[nh - nh // 3:] = p
    if kind == "below":
        hay = hay + dt(64)
        q = rng.integers(-64, 64, nq).astype(dt)
        q = np.minimum(q, hay[0] - 1).astype(dt)
    elif kind == "above":
        q = (int(hay[-1]) + 1 + rng.integers(0, 64, nq)).astype(dt)
    elif kind == "runs":
        q = rng.integers(-1, 12, nq).astype(dt)
    else:
        q = rand(rng, nq, dt, hi=4 * nh)
        q[::7] = p
    return q, hay


# Shapes a search with its top levels in a table can get wrong: 2^L - 1,
# 2^L and 2^L + 1 keys for L = 8, 10 and 12, runs of one key across a
# table node, PAD tails, one key (the card's own table edges, in line
# heads, are held against the plain version in test_torch_cuda.py).
PROBE_CASES = [
    pytest.param(nq, nh, "unique", id=f"{nq}-{nh}")
    for nq, nh in [(64, 16), (256, 100), (1024, 1), (512, 511), (1, 1),
                   (100, 37), (300, 3)]
] + [
    pytest.param(nq, nh, kind, id=f"{kind}-{nq}-{nh}")
    for kind, nq, nh in [
        ("distinct", 128, 255), ("distinct", 128, 257),
        ("distinct", 128, 1023), ("distinct", 128, 1025),
        ("distinct", 256, 4095), ("distinct", 256, 4096),
        ("distinct", 256, 4097), ("runs", 512, 4095), ("runs", 512, 4096),
        ("runs", 512, 4097), ("runs", 300, 1), ("pad_tail", 256, 4097),
        ("pad_tail", 100, 255), ("all_pad", 128, 4096), ("all_pad", 64, 1),
        ("below", 256, 4097), ("below", 64, 1), ("above", 256, 4097),
        ("above", 64, 1)]
]


@pytest.mark.parametrize("dt", ALL_DTYPES)
@pytest.mark.parametrize("nq,nh,kind", PROBE_CASES)
def test_probe(nq, nh, kind, dt):
    q, hay = probe_case(np.random.default_rng(nq + nh), kind, nq, nh, dt)
    got = TK.probe_sorted(torch.from_numpy(q), torch.from_numpy(hay)).numpy()
    np.testing.assert_array_equal(got, np.isin(q, hay).astype(np.int32))
    if dt in REF_DTYPES:
        want = RK.probe_sorted(jnp.asarray(q), jnp.asarray(hay))
        np.testing.assert_array_equal(got, np.asarray(want))


def test_probe_edges():
    e = torch.zeros(0, dtype=torch.int32)
    assert TK.probe_sorted(e, torch.arange(4, dtype=torch.int32)).shape == (0,)
    q = torch.arange(64, dtype=torch.int32)
    assert (TK.probe_sorted(q, e) == 0).all()
    dup_hay = torch.full((32,), 5, dtype=torch.int32)
    got = TK.probe_sorted(torch.tensor([4, 5, 6], dtype=torch.int32), dup_hay)
    np.testing.assert_array_equal(got.numpy(), [0, 1, 0])


def test_wrappers_reject_what_the_kernels_do_not_take():
    k = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        BS.bitonic_sort_tiles(k.float(), k, 8)
    with pytest.raises(TypeError):
        BS.bitonic_sort_tiles(k, k.long(), 8)
    with pytest.raises(ValueError):
        BS.bitonic_sort_tiles(k, k, 3)
    with pytest.raises(TypeError):
        TK.probe_sorted(k, k.long())


def test_cpu_tensors_launch_no_kernel():
    TK.reset_launch_counts()
    check_sort(np.arange(64, dtype=np.int32)[::-1].copy(), tile=16)
    TK.unique_mask(torch.zeros((4, 2), dtype=torch.int32))
    TK.probe_sorted(torch.arange(4), torch.arange(4))
    assert set(TK.launch_counts().values()) == {0}
