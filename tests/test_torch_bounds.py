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
    fraction of the count that takes every product as dense (B3 0.18 of
    it; B4, every input asked for, 0.25 of six dense products an entry: the
    forward step's two, the pull-back's two, R Sigma and dR)."""
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
    assert b3 < b4 < 6 * E * DENSE_PRODUCT / 3


def test_packed_gram_bound_by_hand():
    """B6's bound: the planes' 2 flops per row and (setting, particle) at the
    float32 peak plus the Gram's 72 flops in each of its 3 bf16 parts at the
    bf16 tensor-core peak, against the operands' bytes and the (B, 36) sums."""
    planes, bounds_ = torch.empty((3, 2)), torch.empty((1, 4, 2))
    aug, w0 = torch.empty((8, 5)), torch.empty(5)
    ms, by = chip_smoke.gram_bound(planes, bounds_, aug, w0)
    pairs = 2 * 5
    operations = pairs * 2 * 3 / 67e12 + pairs * 72 * 3 / 989e12
    n_bytes = (3 * 2 + 4 * 2 + 8 * 5 + 5 + 36 * 2) * 4
    assert n_bytes / 3.35e12 > operations  # a tiny launch is bound by its bytes
    assert (ms, by) == pytest.approx((n_bytes / 3.35e12 * 1e3, "bytes"))

    # Path A's shape (B = 256, N = 100,000, 14 plane rows): operations, the
    # planes twice the Gram's tensor-core time.
    planes, bounds_ = torch.empty((14, 256)), torch.empty((1, 4, 256))
    aug, w0 = torch.empty((8, 100_000)), torch.empty(100_000)
    ms, by = chip_smoke.gram_bound(planes, bounds_, aug, w0)
    pairs = 256 * 100_000
    plane_ms, gram_ms = pairs * 28 / 67e12 * 1e3, pairs * 216 / 989e12 * 1e3
    assert by == "operations" and ms == pytest.approx(plane_ms + gram_ms)
    assert 1.5 < plane_ms / gram_ms < 2.5 and 0.015 < ms < 0.018


def test_hist_ab_bound_by_hand():
    """B7's bound at the harness's shape (N = 100,000, window (952, 256)):
    8 bytes a particle and the int32 window, 0.53 us at 3.35 TB/s, for both
    kernels.  The onehot read's own int8 operations, printed apart: per
    16-row tile ceil(pairs / 32) steps of one m16n8k32 mma (8,192
    operations) for each of the window's 8-column tiles, at 1,979 TOP/s."""
    from lynx_tpu_torch.benchmarks import hist_ab

    n, win = 100_000, (952, 256)
    ms, by = chip_smoke.hist_bound(n, win)
    assert by == "bytes" and ms == pytest.approx((8 * n + 4 * 952 * 256) / 3.35e12 * 1e3)
    assert 0.00052 < ms < 0.00054
    # 33 pairs in one tile of a (16, 128) window, two pads dropped: 2 steps
    # of 16 column tiles.
    lx = torch.tensor([3] * 33 + [-1, 16], dtype=torch.int32)
    ly = torch.tensor([5] * 33 + [0, 0], dtype=torch.int32)
    floor = chip_smoke.onehot_floor(torch, lx, ly, (16, 128))
    assert floor == pytest.approx(2 * 16 * 8192 / 1979e12 * 1e3)
    ms, by = chip_smoke.hist_bound(33, (16, 128))
    assert by == "bytes" and ms == pytest.approx((8 * 33 + 4 * 16 * 128) / 3.35e12 * 1e3)
    # The harness's spot: N / 32 steps and at most one ragged step per tile,
    # far below the dense formulation's 2 N win_x win_y operations.
    lx, ly = hist_ab.workload(n, win, seed=0, device="cpu")
    floor = chip_smoke.onehot_floor(torch, lx, ly, win)
    least = n / 32 * 32 * 8192 / 1979e12 * 1e3
    assert least <= floor <= (n / 32 + 60) * 32 * 8192 / 1979e12 * 1e3
    assert floor < 2 * n * 952 * 256 / 1979e12 * 1e3 / 50


@pytest.mark.parametrize("code, cells", [
    (ft.TAPE_UNDULATOR, 10), (ft.TAPE_CAVITY, 13), (ft.TAPE_SOLENOID, 24), (ft.TAPE_CUSTOM, 49),
])
def test_new_kinds_supports_by_hand(code, cells):
    """The structural supports of the new builders' maps: an undulator is a
    drift (identity + 3 cells); an inactive cavity 12 cells and (6, 6); a
    misaligned solenoid its 4x4 block, (4, 5), the diagonal's last three
    and column 6 of rows 0-3; a custom map dense."""
    support, ones = chip_smoke.dynamic_support(ft, code)
    assert bin(support).count("1") == cells
    assert ones & ~support == 0


def test_dipole_support_holds_its_cells():
    """A dipole's map (tilted edges around the body or thin kick) reaches
    the transverse 4x4 block, the dispersion column 5 and row 4 (x, x'),
    column 6 of rows 0-3 (the thin kick turned by the tilt), and the last
    three diagonal cells, which stay exact ones."""
    support, ones = chip_smoke.dynamic_support(ft, ft.TAPE_DIPOLE)
    expected = ([(i, j) for i in range(4) for j in range(4)] + [(i, 5) for i in range(5)]
                + [(4, j) for j in range(4)] + [(i, 6) for i in range(4)]
                + [(4, 4), (5, 5), (6, 6)])
    assert support == chip_smoke.mask_of(expected)
    assert ones == chip_smoke.mask_of([(4, 4), (5, 5), (6, 6)])
