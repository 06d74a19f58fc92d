"""Parity of the port's sparse 7x7 table algebra (``ops/table.py``) and its
table-form entry builders (``ops/rmatrix.py``) with the JAX package.

The same float64 inputs, made with numpy from a seed, go through both
packages.  The algebra's literal structure (which cells stay Python
floats) must be identical, and every tensor cell must agree to 1e-12
relative to the table's largest entry (both evaluate one formula in the
same operation order; only libm's last bit may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lynx_tpu.ops import rmatrix as jax_rmatrix
from lynx_tpu.ops import table as jax_table
from lynx_tpu_torch.ops import rmatrix as torch_rmatrix
from lynx_tpu_torch.ops import table as torch_table

RTOL = 1e-12
B = 5


def assert_tables_close(actual, expected, rtol=RTOL):
    """Same literal layout; tensor cells within rtol * max |cell|."""
    scale = 0.0
    for row in expected:
        for cell in row:
            if not isinstance(cell, float):
                scale = max(scale, float(np.max(np.abs(np.asarray(cell)))))
    for i in range(7):
        for j in range(7):
            a, e = actual[i][j], expected[i][j]
            assert isinstance(a, float) == isinstance(e, float), (i, j)
            if isinstance(e, float):
                assert a == e, (i, j)
            else:
                np.testing.assert_allclose(
                    a.detach().numpy(), np.asarray(e), rtol=rtol, atol=rtol * scale
                )


def random_table(rng, density=0.5):
    """A random table (numpy cells, literal zeros and ones) in both forms."""
    jt, tt = [], []
    for i in range(7):
        jrow, trow = [], []
        for j in range(7):
            u = rng.uniform()
            if u < density:
                v = rng.normal(size=B)
                jrow.append(jnp.asarray(v))
                trow.append(torch.from_numpy(v))
            else:
                literal = 1.0 if i == j or u > 0.9 else 0.0
                jrow.append(literal)
                trow.append(literal)
        jt.append(jrow)
        tt.append(trow)
    return jt, tt


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_compose_matvec_and_sandwich_match_jax(rng):
    ja, ta = random_table(rng)
    jb, tb = random_table(rng, density=0.3)
    assert_tables_close(torch_table.compose(ta, tb), jax_table.compose(ja, jb))
    assert_tables_close(torch_table.cov_sandwich(ta, tb), jax_table.cov_sandwich(ja, jb))
    assert_tables_close(torch_table.add_tables(ta, tb), jax_table.add_tables(ja, jb))
    assert_tables_close(torch_table.transpose_table(ta), jax_table.transpose_table(ja))
    jv, tv = ja[2], ta[2]
    assert_tables_close(torch_table.outer_table(tv, tb[0]), jax_table.outer_table(jv, jb[0]))
    actual = torch_table.matvec(ta, tv)
    expected = jax_table.matvec(ja, jv)
    assert_tables_close([actual] * 7, [expected] * 7)


def test_literals_short_circuit():
    identity = torch_table.identity_table()
    x = torch.arange(3.0)
    table = torch_table.entries_to_table({(0, 1): x, (2, 2): 0.0})
    composed = torch_table.compose(identity, table)
    assert composed[0][1] is x  # multiplying by a literal one is free
    assert composed[2][2] == 0.0 and composed[3][4] == 0.0
    merged = torch_table.where_table(x > 0, table, identity)
    assert merged[5][5] == 1.0 and isinstance(merged[0][1], torch.Tensor)
    stacked = torch_table.table_to_batch_last(table, (3,), torch.float64)
    assert stacked.shape == (7, 7, 3)
    back = torch_table.batch_last_to_table(stacked)
    assert torch.equal(back[0][1], x.double())
    dense = torch_table.table_from_batch_first(stacked.permute(2, 0, 1))
    assert torch.equal(dense[6][6], torch.ones(3, dtype=torch.float64))


def test_base_rmatrix_entries_and_table_match_jax(rng):
    length = rng.uniform(0.1, 0.5, B)
    k1 = np.array([-12.0, -1e-3, 0.0, 2.5, 30.0])  # both branches, k1 = 0
    hx = np.array([0.0, 0.1, 0.0, -0.2, 0.0])
    tilt = rng.uniform(-0.3, 0.3, B)
    energy = rng.uniform(5e7, 2e8, B)
    jargs = [jnp.asarray(a) for a in (length, k1, hx, tilt, energy)]
    targs = [torch.from_numpy(a) for a in (length, k1, hx, tilt, energy)]

    j_entries, j_shape, _, _ = jax_rmatrix.base_rmatrix_entries(*jargs)
    t_entries, t_shape, t_dtype, _ = torch_rmatrix.base_rmatrix_entries(*targs)
    assert tuple(j_shape) == tuple(t_shape) and t_dtype == torch.float64
    assert set(j_entries) == set(t_entries)
    assert_tables_close(
        torch_table.entries_to_table(t_entries), jax_table.entries_to_table(j_entries)
    )
    assert_tables_close(
        torch_rmatrix.base_rmatrix_table(*targs), jax_rmatrix.base_rmatrix_table(*jargs)
    )
    assert_tables_close(
        torch_table.entries_to_table(torch_rmatrix.rotation_entries(targs[3])),
        jax_table.entries_to_table(jax_rmatrix.rotation_entries(jargs[3])),
    )
    # The table form equals the dense builder.
    dense = torch_rmatrix.base_rmatrix(*targs)
    table = torch_rmatrix.base_rmatrix_table(*targs)
    stacked = torch_table.table_to_batch_last(table, (B,), torch.float64).permute(2, 0, 1)
    torch.testing.assert_close(stacked, dense, rtol=RTOL, atol=RTOL)


def test_drift_entries_match_jax(rng):
    length = rng.uniform(0.0, 2.0, B)
    energy = np.array([0.0, 1e6, 1.073e8, 5e8, 1e10])  # E = 0 included
    t_entries = torch_rmatrix.drift_rmatrix_entries(
        torch.from_numpy(length), torch.from_numpy(energy)
    )
    j_entries = jax_rmatrix.drift_rmatrix_entries(jnp.asarray(length), jnp.asarray(energy))
    assert_tables_close(
        torch_table.entries_to_table(t_entries), jax_table.entries_to_table(j_entries)
    )
