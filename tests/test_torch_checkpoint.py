"""Checkpoints of the PyTorch port (``lynx_tpu_torch.checkpoint``): a
Segment, both beam types and an Adam state round trip through a file, and
what is restored tracks (and steps) identically, as the JAX package's
``tests/test_checkpoint.py`` asks of its orbax checkpoints."""

import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import checkpoint, functional
from lynx_tpu_torch.models import ares


def segment(k1=4.2):
    return ltt.Segment(
        [
            ltt.Drift(torch.tensor([0.5]), name="d1"),
            ltt.Segment([ltt.Quadrupole(torch.tensor([0.2]), k1=torch.tensor([k1]), name="q1"),
                         ltt.Drift(torch.tensor([0.3]), name="d2")], name="inner"),
            ltt.Aperture(x_max=torch.tensor([2e-4]), y_max=torch.tensor([3e-4]), name="a1"),
            ltt.Screen(resolution=(64, 48), pixel_size=torch.tensor([1e-5, 1e-5]), name="s1"),
        ],
        name="ckpt_test",
    )


def particle_beam(seed=0):
    return ltt.ParticleBeam.from_parameters(
        num_particles=500, sigma_x=torch.tensor([1e-4]), energy=torch.tensor([1e8]),
        total_charge=torch.tensor([1e-12]), generator=torch.Generator().manual_seed(seed),
    )


def test_segment_round_trip_tracks_identically(tmp_path):
    original = segment()
    original.elements[1].q1.k1 = torch.tensor([3.3])
    checkpoint.save(tmp_path / "segment.pt", original)
    restored = checkpoint.restore(tmp_path / "segment.pt", segment())
    assert isinstance(restored, ltt.Segment) and restored.name == "ckpt_test"
    assert restored == original and restored.elements[1].q1.name == "q1"
    assert restored.s1.resolution == (64, 48)
    beam = particle_beam()
    a, _ = functional.track(original, beam)
    b, _ = functional.track(restored, beam)
    assert torch.equal(a.particles, b.particles) and torch.equal(a.survival, b.survival)


@pytest.mark.parametrize("kind", ["particle", "particle with survival", "parameter"])
def test_beam_round_trip(kind, tmp_path):
    beam = particle_beam(1)
    if kind == "particle with survival":
        beam, _ = functional.track(segment(), beam)
        assert beam.survival is not None
    elif kind == "parameter":
        beam = ltt.ParameterBeam.from_twiss(beta_x=torch.tensor([5.0]), alpha_x=torch.tensor([1.0]),
                                            device="cpu")
    checkpoint.save(tmp_path / "beam.pt", beam)
    template = beam.transformed_to(mu_x=torch.tensor([1e-3]))
    restored = checkpoint.restore(tmp_path / "beam.pt", template)
    assert type(restored) is type(beam)
    for name in ("mu_x", "sigma_x", "emittance_x", "beta_x", "energy", "total_charge"):
        assert torch.equal(getattr(restored, name), getattr(beam, name)), name
    out_a, _ = functional.track(segment(), beam)
    out_b, _ = functional.track(segment(), restored)
    assert torch.equal(out_a.sigma_x, out_b.sigma_x)


def test_adam_state_round_trip_steps_identically(tmp_path):
    """A tuning session: the lattice, the tuned k1 and Adam's state in one
    dict; after restore the next steps are the same as without the save."""
    lattice = ares.ares_ea_segment(device="cpu")
    beam = ltt.ParameterBeam.from_twiss(beta_x=torch.tensor([5.0]), beta_y=torch.tensor([5.0]),
                                        emittance_x=torch.tensor([1e-9]),
                                        emittance_y=torch.tensor([1e-9]),
                                        energy=torch.tensor([1.073e8]), device="cpu")

    def session(k1):
        k1 = torch.nn.Parameter(k1)
        return k1, torch.optim.Adam([k1], lr=5e-2)

    def step(k1, optimizer):
        lattice.AREAMQZM1.k1 = k1
        outgoing, _ = functional.track(lattice, beam)
        loss = outgoing.beta_x.sum() + outgoing.beta_y.sum()
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    k1, optimizer = session(torch.tensor([4.2]))
    for _ in range(3):
        step(k1, optimizer)
    state = {"segment": lattice, "optimizer": optimizer, "k1": k1.detach(), "step": 3}
    checkpoint.save(tmp_path / "session.pt", state)

    fresh_k1, fresh_optimizer = session(torch.tensor([0.0]))
    template = {"segment": ares.ares_ea_segment(device="cpu"), "optimizer": fresh_optimizer,
                "k1": torch.zeros(1), "step": 0}
    restored = checkpoint.restore(tmp_path / "session.pt", template)
    assert restored["optimizer"] is fresh_optimizer and restored["step"] == 3
    with torch.no_grad():
        fresh_k1.copy_(restored["k1"])
    assert restored["segment"] == lattice
    losses = [step(k1, optimizer) for _ in range(2)]
    restored_losses = [step(fresh_k1, fresh_optimizer) for _ in range(2)]
    assert losses == restored_losses
    assert torch.equal(k1, fresh_k1)


def test_restore_refuses_another_structure(tmp_path):
    checkpoint.save(tmp_path / "segment.pt", segment())
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path / "segment.pt", ltt.Segment([ltt.Drift(torch.tensor([1.0]))]))
    checkpoint.save(tmp_path / "beam.pt", particle_beam())
    with pytest.raises(ValueError):
        checkpoint.restore(tmp_path / "beam.pt", ltt.ParticleBeam.from_parameters(
            num_particles=10, generator=torch.Generator()))
