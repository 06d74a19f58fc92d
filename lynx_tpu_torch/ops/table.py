"""Sparse symbolic 7x7 map algebra over batched entry vectors (counterpart of
``lynx_tpu.ops.table``).

A transfer map over a large flat batch is a 7x7 Python table whose cells are
either ``(batch,)`` tensors or literal Python floats (0.0/1.0 for structural
zeros and identity).  Composing tables skips literal zeros and ones when the
table is built, so a chain of mostly sparse maps (a drift has 3 non-trivial
entries of 49) costs a fraction of the dense 343 multiply-adds, and no
``(B, 7, 7)`` tensor is materialised.

This is the plain version of the fused sweep (``ops/fused_track.py``): the
kernels B3 and B4 compute the same composition densely on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch

Tensor = torch.Tensor
Cell = Union[Tensor, float]
Table = List[List[Cell]]  # 7 x 7


def _is_literal(cell: Cell) -> bool:
    return isinstance(cell, (int, float))


def _is_zero(cell: Cell) -> bool:
    return _is_literal(cell) and cell == 0.0


def _is_one(cell: Cell) -> bool:
    return _is_literal(cell) and cell == 1.0


def _mul(a: Cell, b: Cell) -> Cell:
    if _is_zero(a) or _is_zero(b):
        return 0.0
    if _is_one(a):
        return b
    if _is_one(b):
        return a
    return a * b


def _add(a: Cell, b: Cell) -> Cell:
    if _is_zero(a):
        return b
    if _is_zero(b):
        return a
    return a + b


def identity_table() -> Table:
    return [[1.0 if i == j else 0.0 for j in range(7)] for i in range(7)]


def entries_to_table(entries: Dict[Tuple[int, int], Cell]) -> Table:
    """Identity plus the given entries (the table analogue of build_rmatrix)."""
    return [
        [entries.get((i, j), 1.0 if i == j else 0.0) for j in range(7)]
        for i in range(7)
    ]


def compose(second: Table, first: Table) -> Table:
    """``second @ first`` with literal-zero short-circuiting."""
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for k in range(7):
            acc: Cell = 0.0
            for j in range(7):
                acc = _add(acc, _mul(second[i][j], first[j][k]))
            row.append(acc)
        out.append(row)
    return out


def matvec(table: Table, vector: List[Cell]) -> List[Cell]:
    """``T @ v`` for a 7-entry cell vector."""
    out: List[Cell] = []
    for i in range(7):
        acc: Cell = 0.0
        for j in range(7):
            acc = _add(acc, _mul(table[i][j], vector[j]))
        out.append(acc)
    return out


def cov_sandwich(table: Table, cov: Table) -> Table:
    """``T C T^T`` on tables."""
    tc = compose(table, cov)
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for l in range(7):  # noqa: E741
            acc: Cell = 0.0
            for k in range(7):
                acc = _add(acc, _mul(tc[i][k], table[l][k]))
            row.append(acc)
        out.append(row)
    return out


def transpose_table(table: Table) -> Table:
    """``T^T`` (free: only the cells' places change)."""
    return [[table[j][i] for j in range(7)] for i in range(7)]


def add_tables(a: Table, b: Table) -> Table:
    """Cell-wise ``A + B`` with literal-zero short-circuiting."""
    return [[_add(a[i][j], b[i][j]) for j in range(7)] for i in range(7)]


def outer_table(u: List[Cell], v: List[Cell]) -> Table:
    """Rank-1 table ``u v^T``."""
    return [[_mul(u[i], v[j]) for j in range(7)] for i in range(7)]


def where_table(mask: Tensor, then_table: Table, else_table: Table) -> Table:
    """Cell-wise ``torch.where`` merge of two tables (literals preserved when
    both branches agree)."""
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for j in range(7):
            a, b = then_table[i][j], else_table[i][j]
            if _is_literal(a) and _is_literal(b) and a == b:
                row.append(a)
            else:
                row.append(torch.where(mask, a, b))
        out.append(row)
    return out


def broadcast_cell(cell: Cell, batch_shape, dtype, device=None) -> Tensor:
    """A cell as a tensor of ``batch_shape`` (a literal becomes a filled
    tensor on ``device``; a tensor cell keeps its own device)."""
    if _is_literal(cell):
        return torch.full(tuple(batch_shape), float(cell), dtype=dtype, device=device)
    return torch.broadcast_to(cell.to(dtype), tuple(batch_shape))


def table_to_batch_last(table: Table, batch_shape, dtype, device=None) -> Tensor:
    """Materialise a table as a stacked ``(7, 7, *batch)`` tensor."""
    return torch.stack(
        [
            torch.stack(
                [broadcast_cell(cell, batch_shape, dtype, device) for cell in row], dim=0
            )
            for row in table
        ],
        dim=0,
    )


def batch_last_to_table(stacked: Tensor) -> Table:
    return [[stacked[i, j] for j in range(7)] for i in range(7)]


def table_from_batch_first(tm: Tensor) -> Table:
    """``(..., 7, 7)`` tensor -> table of ``(...)`` cells."""
    return [[tm[..., i, j] for j in range(7)] for i in range(7)]
