"""The per-setting particle push (kernel B2's plain version) against the JAX
package's ``fused_particle_sweep`` with its Pallas kernel in interpret mode.

The same float64 lattice and (B, N, 7) particles, made with numpy from a
seed, go through both packages.  The pushed particles agree to 1e-12 and
the gradients of a weighted sum with respect to the particles and the
per-setting k1 to 1e-10, each relative to the output's largest entry.
``Segment.track`` takes the push for (B, N, 7) beams with B >= 16 when the
override is set; ``functional.track`` never takes it, as in JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lynx_tpu.ops.pallas_track as jax_pallas_track
import lynx_tpu_torch as ltt
from lynx_tpu.accelerator import fused as jax_fused
from lynx_tpu_torch import functional
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.accelerator import segment as torch_segment
from lynx_tpu_torch.ops import fused_track

from test_torch_fused_sweep import ENERGY, assert_close, jax_run, lattice_arrays, torch_run

PUSH_RTOL = 1e-12
GRAD_RTOL = 1e-10
B, N = 16, 300


@pytest.fixture
def interpreted_pallas(monkeypatch):
    monkeypatch.setattr(
        jax_pallas_track.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def particles(seed=5):
    rng = np.random.default_rng(seed)
    p = np.ones((B, N, 7))
    p[..., :6] = rng.normal(size=(B, N, 6)) * np.array([1e-4, 2e-5, 1e-4, 2e-5, 8e-6, 2e-3])
    return p


def builders_and_params(elements, vec):
    builders = [torch_fused.element_map_builder(el) if isinstance(el, torch.nn.Module)
                else jax_fused.element_map_builder(el) for el in elements]
    return [fn for _, fn in builders], [[vec(p) for p in params] for params, _ in builders]


def test_plain_push_and_gradients_match_jax(interpreted_pallas):
    a = lattice_arrays(B)
    p = particles()
    w = np.random.default_rng(6).normal(size=(B, N, 7))

    def jax_loss(q1_k1, parts):
        elements = jax_run(a, B)
        elements[2].k1 = q1_k1
        fns, params = builders_and_params(elements, lambda x: jnp.broadcast_to(x, (B,)))
        out = jax_pallas_track.fused_particle_sweep(fns, params, jnp.full(B, ENERGY), parts)
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(a["q1_k1"]), jnp.asarray(p)
    )

    elements = torch_run(a, B)
    q1_k1 = elements[2].k1.clone().requires_grad_(True)
    elements[2].k1 = q1_k1
    parts = torch.from_numpy(p).requires_grad_(True)
    fns, params = builders_and_params(elements, lambda x: torch.broadcast_to(x, (B,)))
    out = fused_track.fused_particle_sweep(
        fns, params, torch.full((B,), ENERGY, dtype=torch.float64), parts
    )
    assert_close(out, j_out, PUSH_RTOL)
    t_grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), (q1_k1, parts))
    for actual, expected in zip(t_grads, j_grads):
        assert_close(actual, expected, GRAD_RTOL)


def test_reference_is_the_dense_product():
    rng = np.random.default_rng(8)
    matrix = torch.from_numpy(rng.normal(size=(B, 49)))
    layout = [[0.0 if (i + j) % 5 == 0 else (1.0 if i == j else 7 * i + j) for j in range(7)]
              for i in range(7)]
    dense = matrix.clone().reshape(B, 7, 7)
    for i in range(7):
        for j in range(7):
            if isinstance(layout[i][j], float):
                dense[:, i, j] = layout[i][j]
    parts = torch.from_numpy(particles())
    expected = torch.matmul(parts, dense.transpose(1, 2))
    actual = fused_track.particle_apply_reference(layout, matrix, parts)
    torch.testing.assert_close(actual, expected, rtol=PUSH_RTOL, atol=PUSH_RTOL * 1e-3)
    zeros, ones = fused_track._layout_masks(layout)
    assert zeros & ones == 0
    literals = [cell for row in layout for cell in row if isinstance(cell, float)]
    assert bin(zeros).count("1") == literals.count(0.0)
    assert bin(ones).count("1") == literals.count(1.0)


def test_segment_track_takes_the_push_and_functional_track_never(monkeypatch):
    a = lattice_arrays(B)
    segment = ltt.Segment(torch_run(a, B))
    beam = ltt.ParticleBeam(torch.from_numpy(particles()), torch.tensor([ENERGY], dtype=torch.float64))
    monkeypatch.setattr(torch_segment, "PARTICLE_SWEEP_PATH", False)
    dense = segment.track(beam)

    calls = []
    original = fused_track.fused_particle_sweep
    monkeypatch.setattr(
        fused_track, "fused_particle_sweep", lambda *args: calls.append(1) or original(*args)
    )
    monkeypatch.setattr(torch_segment, "PARTICLE_SWEEP_PATH", True)
    launches = fused_track.particle_apply.launches
    pushed = segment.track(beam)
    assert calls and fused_track.particle_apply.launches == launches  # plain version on the CPU
    assert_close(pushed.particles, dense.particles, PUSH_RTOL)

    calls.clear()
    outgoing, _ = functional.track(segment, beam)
    assert not calls  # functional.track never takes the particle push
    assert_close(outgoing.particles, dense.particles, PUSH_RTOL)

    # Fewer than 16 settings keep the dense route.
    small = ltt.Segment(torch_run(lattice_arrays(8), 8))
    few = ltt.ParticleBeam(
        torch.from_numpy(particles()[:8]), torch.tensor([ENERGY], dtype=torch.float64)
    )
    small.track(few)
    assert not calls
