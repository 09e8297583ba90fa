"""The port's relation, dictionary and operator layers on the CPU.

* ``Dictionary`` against ``repro.engine.dictionary`` in-process: the same
  constant ids, skolem ids and null decodes, and ``state_dict`` /
  ``load_state`` / ``mark`` / ``rollback`` interchangeable both ways.
* The cores of ``repro_torch.engine.ops`` on random padded blocks at
  int16/int32/int64 against numpy oracles.
* The packed arity-2 key against a numpy emulation of the reference's
  little-endian bitcast, negative (skolem) ids included.
"""
import numpy as np
import pytest
import torch

from repro.engine.dictionary import Dictionary as RefDictionary
from repro_torch.engine import ops
from repro_torch.engine.dictionary import Dictionary
from repro_torch.engine.relation import (Relation, host_order, lex_order,
                                         pad_value, torch_dtype)

DTYPES = [np.int16, np.int32, np.int64]


def encode_both(dicts, rng):
    """Feed the same mixed batches to every dictionary; return the ids."""
    out = []
    strs = np.array([f"c{i}" for i in rng.integers(0, 40, 60)], dtype=object)
    ints = rng.integers(-5, 1000, (30, 2))
    for d in dicts:
        ids = [d.encode_columns(strs.reshape(-1, 2)),
               d.encode_columns(ints),
               np.array(d.encode_many(["x", 7, "c3", ("tup", 1)])),
               np.array([d.skolem(("r1", "Z", (i % 5,))) for i in range(9)]),
               np.array([d.encode(d.decode(-2)), d.encode("c0"), d.encode(3)])]
        out.append(ids)
    return out


@pytest.mark.parametrize("dt", DTYPES)
def test_dictionary_assigns_the_references_ids(dt):
    rng = np.random.default_rng(0)
    ref, port = RefDictionary(id_dtype=dt), Dictionary(id_dtype=dt)
    a, b = encode_both([ref, port], rng)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(ref) == len(port) and ref.num_nulls == port.num_nulls
    for i in range(-port.num_nulls, len(port)):
        r, p = ref.decode(i), port.decode(i)
        assert repr(r) == repr(p) and type(r).__name__ == type(p).__name__


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_dictionary_state_crosses_packages(direction):
    rng = np.random.default_rng(1)
    ref, port = RefDictionary(id_dtype=np.int32), Dictionary(id_dtype=np.int32)
    src, dst = (ref, port) if direction == "ref_to_port" else (port, ref)
    encode_both([src], rng)
    dst.load_state(src.state_dict())
    # both continue identically from the carried state
    a, b = encode_both([src, dst], np.random.default_rng(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    st_a, st_b = src.state_dict(), dst.state_dict()
    assert st_a.keys() == st_b.keys()
    for k in st_a:
        if isinstance(st_a[k], np.ndarray):
            np.testing.assert_array_equal(st_a[k], st_b[k])
        else:
            assert st_a[k] == st_b[k]


def test_dictionary_mark_rollback_matches_reference():
    ref, port = RefDictionary(id_dtype=np.int16), Dictionary(id_dtype=np.int16)
    for d in (ref, port):
        d.encode_columns(np.array([["a", "b"]], dtype=object))
        tok = d.mark()
        d.encode_columns(np.array([["c", "d"]], dtype=object))
        d.skolem(("r", "Z", (1,)))
        d.rollback(tok)
        d.encode("e")
    assert ref.state_dict()["to_id"] == port.state_dict()["to_id"]
    assert ref.num_nulls == port.num_nulls == 0


def test_relation_range_check_and_padding():
    with pytest.raises(OverflowError):
        Relation.from_numpy(np.array([[40000]], np.int32), dtype=np.int16,
                            device="cpu")
    r = Relation.from_numpy(np.array([[1, 2], [3, 4], [5, 6]], np.int64),
                            device="cpu")
    assert r.capacity == 4 and r.count == 3 and r.dtype == np.int64
    assert (r.data[3] == pad_value(np.int64)).all()
    assert Relation.empty(2, dtype=np.int16, device="cpu").data.dtype == \
        torch.int16


# ---------------------------------------------------------------------------
# cores against numpy oracles
# ---------------------------------------------------------------------------
def padded_block(rng, n, cap, ar, dt, hi=6, lo=0):
    rows = rng.integers(lo, hi, (n, ar)).astype(dt)
    data = np.full((cap, ar), pad_value(dt), dt)
    data[:n] = rows
    return data


def tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ar", [1, 2, 3])
@pytest.mark.parametrize("cap", [64, 100])
def test_lexsort_core(cap, ar, dt):
    rng = np.random.default_rng(cap * ar)
    data = padded_block(rng, cap - 9, cap, ar, dt, lo=-3)
    got = ops.lexsort_core(tensor(data)).numpy()
    np.testing.assert_array_equal(got, data[host_order(data)])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ar", [1, 2, 3])
def test_dedup_and_keysort(ar, dt):
    rng = np.random.default_rng(ar)
    data = padded_block(rng, 50, 64, ar, dt, hi=4)
    rel = ops.dedup(Relation(tensor(data), 50))
    want = np.unique(data[:50], axis=0)
    assert rel.count == len(want) and rel.sorted_by == lex_order(ar)
    np.testing.assert_array_equal(np.sort(rel.np_rows(), axis=0),
                                  np.sort(want, axis=0))
    assert (rel.data[rel.count:] == pad_value(dt)).all()
    s = ops.keysort_core(tensor(data), ar - 1).numpy()
    np.testing.assert_array_equal(
        s, data[np.argsort(data[:, ar - 1], kind="stable")])


@pytest.mark.parametrize("dt", DTYPES)
def test_compact_project_filter(dt):
    rng = np.random.default_rng(3)
    data = padded_block(rng, 40, 64, 3, dt)
    mask = ops.filter_mask_core(tensor(data), eq_pairs=((0, 1),),
                                const_pairs=((2, 3),))
    want = (data[:, 0] == data[:, 1]) & (data[:, 2] == 3)
    want &= data[:, 0] != pad_value(dt)
    np.testing.assert_array_equal(mask.numpy(), want)
    out = ops.compact_core(tensor(data), mask, 16).numpy()
    k = int(want.sum())
    np.testing.assert_array_equal(out[:k], data[want][:16])
    assert (out[k:] == pad_value(dt)).all()
    proj = ops.project_core(tensor(data), (2, 0)).numpy()
    np.testing.assert_array_equal(proj[:40], data[:40][:, [2, 0]])
    assert (proj[40:] == pad_value(dt)).all()


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("sizes", [(30, 50), (64, 7), (1, 1)])
def test_sm_join(sizes, dt):
    rng = np.random.default_rng(sum(sizes))
    nl, nr = sizes
    ld = padded_block(rng, nl, 64, 2, dt, hi=8)
    rd = padded_block(rng, nr, 64, 2, dt, hi=8)
    out, m = ops.sm_join(Relation(tensor(ld), nl), Relation(tensor(rd), nr),
                         1, 0)
    want = [tuple(a) + tuple(b) for a in ld[:nl] for b in rd[:nr]
            if a[1] == b[0]]
    assert m == len(want) == out.count
    assert sorted(map(tuple, out.np_rows().tolist())) == \
        sorted(tuple(int(x) for x in w) for w in want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ar", [1, 2, 3])
def test_antijoin_semijoin_member(ar, dt):
    rng = np.random.default_rng(10 + ar)
    hay = padded_block(rng, 40, 64, ar, dt, hi=4, lo=-2)
    hay_rel = ops.dedup(Relation(tensor(hay), 40))
    probe = padded_block(rng, 50, 64, ar, dt, hi=5, lo=-2)
    hs = {tuple(r) for r in hay[:40].tolist()}
    keep = [tuple(r) not in hs for r in probe[:50].tolist()]
    anti = ops.antijoin(Relation(tensor(probe), 50), hay_rel)
    np.testing.assert_array_equal(anti.np_rows(), probe[:50][keep])
    semi = ops.semijoin(Relation(tensor(probe), 50), hay_rel)
    np.testing.assert_array_equal(semi.np_rows(),
                                  probe[:50][~np.array(keep)])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ar", [1, 2, 3])
def test_merge_union(ar, dt):
    rng = np.random.default_rng(20 + ar)
    a = ops.dedup(Relation(tensor(padded_block(rng, 60, 64, ar, dt, hi=5,
                                               lo=-2)), 60))
    b = ops.dedup(Relation(tensor(padded_block(rng, 30, 32, ar, dt, hi=6,
                                               lo=-2)), 30))
    b = ops.antijoin(b, a)
    m = ops.merge_union(a, b)
    rows = np.concatenate([a.np_rows(), b.np_rows()])
    np.testing.assert_array_equal(m.np_rows(), rows[host_order(rows)])
    assert m.is_lexsorted and m.count == a.count + b.count


@pytest.mark.parametrize("dt", [np.int16, np.int32])
def test_pack_rows2_is_the_references_bitcast(dt):
    """The reference packs [col1, col0] by a little-endian bitcast, so
    column 1 is the unsigned low word; negative skolem ids sort after every
    constant there."""
    rng = np.random.default_rng(5)
    info = np.iinfo(dt)
    rows = rng.integers(info.min, info.max, (200, 2)).astype(dt)
    rows[:4] = [[0, 1], [0, -1], [-1, 0], [info.max, info.max]]
    wide = np.int32 if dt == np.int16 else np.int64
    want = np.ascontiguousarray(rows[:, ::-1]).view(wide).reshape(-1)
    got = ops.pack_rows2(tensor(rows)).numpy()
    assert got.dtype == wide
    np.testing.assert_array_equal(got, want)
    assert got[0] < got[1]                  # [0, 1] before [0, -1]


def test_cross_and_union():
    l = Relation.from_numpy(np.array([[1], [2]], np.int32), device="cpu")
    r = Relation.from_numpy(np.array([[5, 6], [7, 8], [9, 9]], np.int32),
                            device="cpu")
    out, m = ops.cross(l, r)
    assert m == 6 and out.capacity == 8
    assert out.rows_set() == {(a, b, c) for a in (1, 2)
                              for b, c in ((5, 6), (7, 8), (9, 9))}
    u = ops.union(l, Relation.from_numpy(np.array([[2], [3]], np.int32),
                                         device="cpu"))
    assert u.rows_set() == {(1,), (2,), (3,)} and u.is_lexsorted


def test_torch_dtype_names():
    assert torch_dtype("int16") == torch.int16
    assert torch_dtype(np.int64) == torch.int64
