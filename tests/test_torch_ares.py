"""The flagship slice end to end: the ARES Experimental Area track and the
AREABSCR1 screen read, JAX package against PyTorch port.

The same numpy particles (10k, seeded) go through both.  In float64, with
both lattices cast to float64, outgoing moments agree to 1e-12 relative and
the (B, 2040, 2448) images are exactly equal, serial and at B = 8.  In
float32 the two libms' transfer maps differ by about an ulp, which moves a
few particles across bin edges: mass stays equal and at most 0.1% of the
particles land in another bin.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.functional as jax_functional
import lynx_tpu_torch.ops.histogram as torch_hist
from lynx_tpu.models import ares_ea_segment as jax_ares_ea_segment
from lynx_tpu_torch import Segment, functional
from lynx_tpu_torch.converters import from_jax_arrays, load_cheetah_model
from lynx_tpu_torch.models import ares as torch_ares
from lynx_tpu_torch.particles import ParticleBeam

N = 10_000
K1 = torch_ares.FLAGSHIP_K1
STATS = ("mu_x", "mu_xp", "mu_y", "mu_yp", "sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
         "sigma_s", "sigma_p")


@pytest.fixture(scope="module")
def jax_segment():
    return jax_ares_ea_segment()


def flagship_particles(batch, seed=0):
    rng = np.random.default_rng(seed)
    scales = np.array([1.75e-4, 2e-5, 1.75e-4, 2e-5, 8e-6, 2e-3])
    p = np.ones((batch, N, 7))
    p[..., :6] = rng.normal(size=(batch, N, 6)) * scales
    return p


def k1_values(batch):
    """Per-setting k1: the working point, spread by up to 5% across a batch."""
    spread = 1.0 + 0.05 * np.linspace(-1.0, 1.0, batch) if batch > 1 else np.ones(1)
    return {name: k1 * spread for name, k1 in K1.items()}


def jax_flagship(segment, batch, dtype, active):
    if batch > 1:
        segment = segment.broadcast((batch,))
    segment = jax.tree_util.tree_map(lambda a: a.astype(dtype), segment)
    segment.AREABSCR1.is_active = active
    for name, values in k1_values(batch).items():
        getattr(segment, name).k1 = jnp.asarray(values, dtype=dtype)
    return segment


def torch_flagship(batch, dtype, active):
    segment = torch_ares.ares_ea_segment(device="cpu")
    if batch > 1:
        segment = segment.broadcast((batch,))
    segment = segment.to(dtype)
    segment.AREABSCR1.is_active = active
    for name, values in k1_values(batch).items():
        getattr(segment, name).k1 = torch.from_numpy(values).to(dtype)
    return segment


def beams(batch, jdtype, tdtype):
    p = flagship_particles(batch)
    energy = np.full(batch, 1.073e8)
    jb = lt.ParticleBeam(jnp.asarray(p, dtype=jdtype), jnp.asarray(energy, dtype=jdtype))
    tb = ParticleBeam(torch.from_numpy(p).to(tdtype), torch.from_numpy(energy).to(tdtype))
    return jb, tb


def test_derived_window_matches_jax(jax_segment):
    torch_ares._EA_WINDOW_CACHE.clear()
    assert torch_ares.ares_ea_segment(device="cpu").AREABSCR1.histogram_window == (244, 950)
    assert jax_segment.AREABSCR1.histogram_window == (244, 950)
    window = torch_hist._window_shape((950, 244), 2040, 2448)
    assert window == (952, 256)


def test_loader_matches_jax_lattice(jax_segment):
    """LatticeJSON load and the from_jax_arrays route build the same
    segment as JAX: names, classes and every data field."""
    loaded = torch_ares.ares_ea_segment(device="cpu")
    carried = from_jax_arrays(jax_segment, device="cpu")
    assert isinstance(carried, Segment)
    assert len(loaded.elements) == len(carried.elements) == len(jax_segment.elements) == 13
    for mine, theirs, jaxs in zip(loaded.elements, carried.elements, jax_segment.elements):
        assert mine.name == theirs.name == jaxs.name
        assert type(mine).__name__ == type(theirs).__name__ == type(jaxs).__name__
        for field in type(jaxs)._all_data_fields:
            expected = np.asarray(getattr(jaxs, field))
            np.testing.assert_array_equal(getattr(mine, field).numpy(), expected)
            np.testing.assert_array_equal(getattr(theirs, field).numpy(), expected)
    assert carried.AREABSCR1.resolution == loaded.AREABSCR1.resolution == (2448, 2040)
    assert carried.AREABSCR1.histogram_window == (244, 950)


def test_full_lattice_names_the_missing_element_types(tmp_path):
    """The full lattice loads (all 11 types are ported); a file with types
    the port lacks raises, naming every one of them."""
    assert len(torch_ares.ares_lattice(device="cpu").elements) == 195
    document = {
        "root": "cell",
        "elements": {"S1": ["Septum", {}], "K1": ["Kicker", {}], "D1": ["Drift", {"length": [1]}]},
        "lattices": {"cell": ["S1", "K1", "D1"]},
    }
    path = tmp_path / "lattice.json"
    path.write_text(json.dumps(document))
    with pytest.raises(NotImplementedError, match="ported to lynx_tpu_torch yet: Kicker, Septum$"):
        load_cheetah_model(str(path), device="cpu")


@pytest.mark.parametrize("batch", [1, 8])
def test_flagship_float64_matches_jax(jax_segment, batch, monkeypatch):
    jb, tb = beams(batch, jnp.float64, torch.float64)

    # Outgoing moments with the screen inactive.
    j_out, _ = jax_functional.track(jax_flagship(jax_segment, batch, jnp.float64, False), jb)
    t_out, _ = functional.track(torch_flagship(batch, torch.float64, False), tb)
    for stat in STATS:
        expected = np.asarray(getattr(j_out, stat))
        np.testing.assert_allclose(getattr(t_out, stat).numpy(), expected, rtol=1e-12, atol=0)

    # The screen image: exactly equal, through the scatter (the CPU route)
    # and through kernel B1's plain version with its placement.
    _, j_diag = jax_functional.track(jax_flagship(jax_segment, batch, jnp.float64, True), jb)
    expected = np.asarray(j_diag["AREABSCR1"])
    assert expected.shape == (batch, 2040, 2448)
    segment = torch_flagship(batch, torch.float64, True)
    _, t_diag = functional.track(segment, tb)
    np.testing.assert_array_equal(t_diag["AREABSCR1"].numpy(), expected)
    assert float(t_diag["AREABSCR1"].sum()) == batch * N

    torch_hist.reset_histogram_fallback_count()
    monkeypatch.setattr(torch_hist, "SCREEN_WINDOWED_PATH", True)
    segment.track(tb)
    np.testing.assert_array_equal(segment.AREABSCR1.reading.numpy(), expected)
    assert torch_hist.histogram_fallback_count() == 0


def test_flagship_float32_close_to_jax(jax_segment):
    jb, tb = beams(1, jnp.float32, torch.float32)
    _, j_diag = jax_functional.track(jax_flagship(jax_segment, 1, jnp.float32, True), jb)
    _, t_diag = functional.track(torch_flagship(1, torch.float32, True), tb)
    expected, actual = np.asarray(j_diag["AREABSCR1"]), t_diag["AREABSCR1"].numpy()
    assert actual.dtype == expected.dtype == np.float32
    assert actual.sum() == expected.sum() == N
    moved = np.abs(actual - expected).sum() / 2
    assert moved <= 0.001 * N
