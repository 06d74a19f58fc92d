"""The port's ``optimize_speed`` example against the JAX package's four
stages, in float64 on the CPU: a FODO lattice of a few cells (the
example's 150 cells compile for minutes on JAX's CPU backend), and stage 4
at 8 settings.  Each stage's outgoing ``mu`` and ``cov`` equal JAX's to
1e-12 relative (each to its largest entry), the lattice built in float32
and cast as JAX's ``fodo_lattice`` is.  JAX's ``broadcast`` drops
float64 (``ROADMAP.md`` §C), so stage 4 is held, row by row, to JAX's
unbatched merged lattice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
from lynx_tpu.models import fodo_lattice as jax_fodo_lattice
from lynx_tpu_torch.examples import optimize_speed

RTOL = 1e-12
CELLS, BATCH = 3, 8


def assert_close(actual, expected):
    actual, expected = actual.detach().numpy(), np.asarray(expected)
    assert actual.shape == expected.shape, (actual.shape, expected.shape)
    scale = float(np.max(np.abs(expected)))
    np.testing.assert_allclose(actual, expected, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture
def port_stages(monkeypatch):
    # JAX's fodo_lattice is built in float32 and cast, so the port's is too.
    build = optimize_speed.build_lattice
    monkeypatch.setattr(optimize_speed, "build_lattice", lambda cells, dtype, device: build(
        cells, torch.float32, device).to(dtype))
    return optimize_speed.main(CELLS, BATCH, device="cpu", dtype=torch.float64, iters=1)


def jax_stages():
    lattice = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_fodo_lattice(CELLS))
    beam = lt.ParameterBeam.from_parameters(
        sigma_x=jnp.array([1.75e-4]), energy=jnp.array([1e8]), dtype=jnp.float64
    )
    as_drifts = lattice.without_inactive_markers().inactive_elements_as_drifts()
    merged = as_drifts.transfer_maps_merged(incoming_beam=beam)
    return [segment.track(beam) for segment in (lattice, as_drifts, merged)]


def test_stages_match_jax(port_stages):
    labels = [label for label, *_ in port_stages]
    assert labels[:3] == ["unoptimized track", "inactive markers removed, inactive as drifts",
                          "transfer_maps_merged"]
    reference = jax_stages()
    for (_, seconds, ours, _), theirs in zip(port_stages[:3], reference):
        assert seconds > 0
        assert_close(ours._mu, theirs._mu)
        assert_close(ours._cov, theirs._cov)
    batched = port_stages[3][2]
    assert batched._mu.shape == (BATCH, 7) and batched._mu.dtype == torch.float64
    for i in range(BATCH):
        assert_close(batched._mu[i], reference[2]._mu[0])
        assert_close(batched._cov[i], reference[2]._cov[0])


def test_stages_shrink_the_lattice(capsys):
    stages = optimize_speed.stages(
        optimize_speed.build_lattice(CELLS, torch.float64, "cpu"),
        optimize_speed.ltt.ParameterBeam.from_parameters(
            sigma_x=torch.tensor([1.75e-4], dtype=torch.float64),
            energy=torch.tensor([1e8], dtype=torch.float64), dtype=torch.float64, device="cpu"),
        BATCH,
    )
    lengths = [len(segment.elements) for _, segment, _ in stages]
    assert lengths[0] == 8 + 7 * CELLS
    assert lengths[1] == lengths[0] - CELLS  # one marker a cell
    assert lengths[2] == 1  # every element of the lattice is linear
    assert stages[3][2]._mu.shape == (BATCH, 7)
