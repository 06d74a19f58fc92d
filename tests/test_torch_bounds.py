"""The operation counts behind ``chip_smoke.py``'s bounds of kernels B3 and
B4: products counted on the maps' structural supports (a multiply for each
term without a structural one, an add between terms), by hand on small
plans."""

from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.accelerator import fused
from lynx_tpu_torch.ops import fused_track as ft

#: A dense 7x7 product: 49 cells of 7 multiplies and 6 adds.
DENSE_PRODUCT = 49 * 13


def const_entry(layout):
    return ("const", layout, sum(not isinstance(c, float) for row in layout for c in row))


def test_product_of_dense_maps_and_of_identities():
    dense, ones, flops = chip_smoke.product(chip_smoke.DENSE, 0, chip_smoke.DENSE, 0)
    assert (dense, ones, flops) == (chip_smoke.DENSE, 0, DENSE_PRODUCT)
    identity = chip_smoke.IDENTITY
    assert chip_smoke.product(identity, identity, identity, identity) == (identity, identity, 0)
    # A map times the identity costs nothing: every term has a structural one.
    assert chip_smoke.product(chip_smoke.DENSE, 0, identity, identity)[2] == 0


@pytest.mark.parametrize("n_entries", [1, 2, 3])
def test_dense_const_plan_costs_dense_products(n_entries):
    """Const maps with no literal cell: B3 is the chain (the first product,
    by the identity, is free), T mu and two dense products for T C T^T."""
    layout = [[0] * 7 for _ in range(7)]
    entries = (const_entry(layout),) * n_entries
    b3, b4 = chip_smoke.sweep_flops(ft, entries)
    assert b3 == (n_entries - 1) * DENSE_PRODUCT + 7 * 13 + 2 * DENSE_PRODUCT
    assert b4 > b3


def test_one_drift_by_hand():
    """A drift's map is the identity and cells (0, 1), (2, 3), (4, 5): T mu
    is 3 rows of one multiply and one add, T C and (T C) T^T 21 cells of
    the same each."""
    entries = (("dyn", SimpleNamespace(tape_kind=ft.TAPE_DRIFT), 1),)
    b3, _ = chip_smoke.sweep_flops(ft, entries)
    assert b3 == 3 * 2 + 21 * 2 + 21 * 2


def test_path_t_plan_counts_far_below_its_dense_count():
    """The env's plan (path T's, at a small batch): the sparse count is a
    fraction of the count that takes every product as dense (B3 0.18, B4
    0.28 of it)."""
    B = 4
    env = make_env(device="cpu")
    tuned = env._batched_tuned_segment(torch.zeros((B, 5)))
    plan = fused.plan_run(
        [fused.element_map_builder(el) for el in tuned.flattened().elements],
        torch.tensor([1.073e8]), lambda x: torch.broadcast_to(x, (B,)).reshape(B),
    )
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    E = len(entries)
    b3, b4 = chip_smoke.sweep_flops(ft, entries)
    assert 0 < b3 < (E + 2) * DENSE_PRODUCT / 4
    assert b3 < b4 < (3 * E + 6) * DENSE_PRODUCT / 3
