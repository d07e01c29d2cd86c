"""The port's ``ops/gridhash`` against the JAX package's, on the same
inputs: the six cases of tests/test_gridhash.py run through both, the
grid's fields bitwise, the int32 hash's wrap on large coordinates, and a
JAX grid carried over by ``convert.hash_grid_from_numpy``.

Tolerances: ``build_grid``'s fields bitwise (the same int32 hash, stable
sort, counts and float32 division).  ``nn_gridhash``: identical indices
and found sets; distances within D - 1 ulp (XLA's CPU backend contracts
the squared-difference sum into FMAs, tests/test_torch_batched.py).
Against brute force, the JAX tests' own contract.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp_rust_tpu.ops import gridhash as j_grid
from icp_rust_tpu_torch import convert
from icp_rust_tpu_torch.ops import gridhash
from icp_rust_tpu_torch.ops.nn import nn_torch

FIELDS = ("points", "index", "starts", "counts", "cell_size",
          "overflow_frac")


def _both(db, db_mask, r, query, table_size, bucket_cap, query_cap=None):
    """The JAX and the port's grid and query results on the same arrays."""
    jg = j_grid.build_grid(jnp.asarray(db), jnp.asarray(db_mask), r,
                           table_size=table_size, bucket_cap=bucket_cap)
    g = gridhash.build_grid(torch.as_tensor(db), torch.as_tensor(db_mask), r,
                            table_size=table_size, bucket_cap=bucket_cap)
    for f in FIELDS:
        want, got = np.array(getattr(jg, f)), getattr(g, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (g.table_size, g.bucket_cap) == (jg.table_size, jg.bucket_cap)
    jr = j_grid.nn_gridhash(jnp.asarray(query), jg, bucket_cap=query_cap)
    r_ = gridhash.nn_gridhash(torch.as_tensor(query), g,
                              bucket_cap=query_cap)
    np.testing.assert_array_equal(r_.index.numpy(), np.array(jr.index))
    want_d = np.array(jr.dist_sq)
    found = np.isfinite(want_d)
    np.testing.assert_array_equal(np.isfinite(r_.dist_sq.numpy()), found)
    np.testing.assert_array_max_ulp(r_.dist_sq.numpy()[found], want_d[found],
                                    maxulp=max(db.shape[1] - 1, 1))
    return g, r_


def _brute(query, db, db_mask):
    res = nn_torch(torch.as_tensor(query), torch.as_tensor(db),
                   torch.as_tensor(db_mask), tile=len(db))
    return res.index.numpy(), res.dist_sq.numpy()


@pytest.mark.parametrize("d", [2, 3])
def test_gridhash_matches_jax_and_brute_force(d):
    rng = np.random.default_rng(0)
    m, q, r = 800, 300, 0.25
    db = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    db_mask = rng.random(m) > 0.1
    query = rng.uniform(-3, 3, (q, d)).astype(np.float32)
    g, res = _both(db, db_mask, r, query, 1 << 12, 32, 32)
    assert float(g.overflow_frac) == 0.0
    idx, best = _brute(query, db, db_mask)
    found = np.isfinite(res.dist_sq.numpy())
    np.testing.assert_array_equal(found, best < np.float32(r) ** 2)
    np.testing.assert_array_equal(res.index.numpy()[found], idx[found])
    np.testing.assert_array_equal(res.dist_sq.numpy()[found], best[found])


def test_gridhash_boundary_queries_match_jax():
    db = np.asarray([[0.09, 0.0], [-0.09, 0.0]], np.float32)
    _, res = _both(db, np.ones(2, bool), 0.1,
                   np.zeros((1, 2), np.float32), 256, 4, 4)
    assert np.isfinite(float(res.dist_sq[0])) and int(res.index[0]) == 0


def test_gridhash_no_neighbor_in_radius_matches_jax():
    _, res = _both(np.asarray([[10.0, 10.0]], np.float32), np.ones(1, bool),
                   0.5, np.zeros((1, 2), np.float32), 256, 4, 4)
    assert not np.isfinite(float(res.dist_sq[0]))
    assert int(res.index[0]) == 0


def test_gridhash_negative_coordinates_match_jax():
    rng = np.random.default_rng(3)
    db = rng.uniform(-1.0, -0.2, (200, 3)).astype(np.float32)
    query = db + rng.normal(0, 0.01, db.shape).astype(np.float32)
    _, res = _both(db, np.ones(200, bool), 0.1, query, 1 << 10, 32, 32)
    _, best = _brute(query, db, np.ones(200, bool))
    assert np.isfinite(res.dist_sq.numpy()).all()
    np.testing.assert_array_equal(res.dist_sq.numpy(), best)


def test_gridhash_overflow_reported_as_jax():
    g, _ = _both(np.zeros((100, 2), np.float32), np.ones(100, bool), 0.1,
                 np.zeros((3, 2), np.float32), 64, 4)
    assert float(g.overflow_frac) > 0.9


def test_gridhash_default_cap_matches_jax_through_jit():
    """The grid's own bucket_cap drives the query when none is given (the
    JAX case runs under jit; the port's has no trace)."""
    rng = np.random.default_rng(7)
    db = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    query = db + np.float32(0.01)

    @jax.jit
    def run(q, d):
        grid = j_grid.build_grid(d, jnp.ones(200, bool), 0.2,
                                 table_size=1 << 10, bucket_cap=32)
        return j_grid.nn_gridhash(q, grid)

    jr = run(jnp.asarray(query), jnp.asarray(db))
    g = gridhash.build_grid(torch.as_tensor(db), torch.ones(200, dtype=bool),
                            0.2, table_size=1 << 10, bucket_cap=32)
    res = gridhash.nn_gridhash(torch.as_tensor(query), g)
    assert np.isfinite(res.dist_sq.numpy()).all()
    np.testing.assert_array_equal(res.index.numpy(), np.array(jr.index))


def test_gridhash_hash_wraps_as_int32_like_jax():
    """Cells of large negative coordinates multiply past int32: both wrap,
    shift arithmetically and floor-mod after abs (abs(INT_MIN) stays
    negative in both)."""
    rng = np.random.default_rng(5)
    db = (rng.uniform(-1, 1, (500, 3)) * 1e6 - 4e7).astype(np.float32)
    db[:50] = db[50:100] + rng.normal(0, 0.1, (50, 3)).astype(np.float32)
    cells = jnp.asarray([[-2 ** 31, 0, 0], [2 ** 31 - 1, -7, 3]], jnp.int32)
    np.testing.assert_array_equal(
        gridhash._hash_cells(torch.as_tensor(np.array(cells)), 1 << 10)
        .numpy(), np.array(j_grid._hash_cells(cells, 1 << 10)))
    _both(db, np.ones(500, bool), 0.5, db[:80] + np.float32(0.05), 1 << 10,
          8)


def test_hash_grid_from_numpy_gives_jax_results():
    rng = np.random.default_rng(9)
    db = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    query = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    jg = j_grid.build_grid(jnp.asarray(db), jnp.asarray(rng.random(600) > .2),
                           0.3, table_size=1 << 11, bucket_cap=8)
    g = convert.hash_grid_from_numpy(
        *[np.array(getattr(jg, f)) for f in FIELDS], jg.table_size,
        jg.bucket_cap)
    assert isinstance(g, gridhash.HashGrid)
    assert dataclasses.is_dataclass(g) and g.bucket_cap == 8
    jr = j_grid.nn_gridhash(jnp.asarray(query), jg)
    res = gridhash.nn_gridhash(torch.as_tensor(query), g)
    np.testing.assert_array_equal(res.index.numpy(), np.array(jr.index))
    np.testing.assert_array_max_ulp(
        res.dist_sq.numpy()[np.isfinite(res.dist_sq.numpy())],
        np.array(jr.dist_sq)[np.isfinite(np.array(jr.dist_sq))], maxulp=2)
    with pytest.raises(ValueError, match="starts"):
        convert.hash_grid_from_numpy(
            *[np.array(getattr(jg, f)) for f in FIELDS], 1 << 10, 8)
