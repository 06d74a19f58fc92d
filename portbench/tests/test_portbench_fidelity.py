"""The particle-fidelity cell ``ea_particles.fidelity_256`` at its small size
on the CPU (``portbench/tests/small/ea_particles.fidelity_256.json``: 2,000
particles, 32 environments, rollouts of 4): it runs correct through
``run_cell``, and its comparison fails for each fault planted in the
program (half of the particles observed, a stale step's observation,
another environment's settings observed) and for the control (the reference
in TF32), as for the reference's own planted faults."""

import pytest
import torch

from conftest import ROOT, SMALL
from portbench import compare, harness
from portbench.run import run_cell

CELL = "ea_particles.fidelity_256"


def run(seed=2**31 + 13):
    return run_cell(ROOT, CELL, seed, 0.3, 0, device="cpu", overrides=SMALL[CELL],
                    log=lambda message: None)


def test_the_cell_runs_correct_on_the_cpu():
    result = run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"env_transitions_per_s", "setup_s"}
    assert set(result["checks"]) == {"obs_gap", "reward_gap", "action_gap"}


def half_of_the_particles(monkeypatch):
    from lynx_tpu_torch.envs import ares_ea

    real = ares_ea.sweep_particle_moments

    def sweep(entries, scalars, particles, weights, **kwargs):
        half = particles.shape[0] // 2
        return real(entries, scalars, particles[:half], weights[:half], **kwargs)

    monkeypatch.setattr(ares_ea, "sweep_particle_moments", sweep)


def a_stale_step(monkeypatch):
    from lynx_tpu_torch.envs.ares_ea import AresEATransverseTuning

    real = AresEATransverseTuning.batched_step

    def batched_step(self, states, actions, params):
        obs, next_states, rewards, dones = real(self, states, actions, params)
        stale = self._batched_observation(states.magnets, params) * 1e3
        return torch.cat([obs[:, :5], stale, obs[:, 9:]], dim=-1), next_states, rewards, dones

    monkeypatch.setattr(AresEATransverseTuning, "batched_step", batched_step)


def another_environments_settings(monkeypatch):
    from lynx_tpu_torch.envs.ares_ea import AresEATransverseTuning

    real = AresEATransverseTuning._batched_observation
    monkeypatch.setattr(AresEATransverseTuning, "_batched_observation",
                        lambda self, magnets, params: real(self, torch.roll(magnets, 1, 0),
                                                           params))


@pytest.mark.parametrize("fault", [half_of_the_particles, a_stale_step,
                                   another_environments_settings])
def test_a_fault_planted_in_the_program_fails(fault, monkeypatch):
    fault(monkeypatch)
    result = run()
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["tf32", "half_batch", "stale", "other_env"])
def test_the_control_and_the_reference_faults_fail_the_limits(kind):
    cell = harness.find_cell(ROOT, CELL, SMALL[CELL])
    numbers, _ = harness.control(cell, 2**31 + 9, "cpu", kind)
    correct, checks = compare.verdict(numbers, cell.limits)
    assert not correct, checks


def test_work_counts_the_gram_at_the_tensor_rate():
    """One Gram of the cloud a step, 36 multiply-adds a particle, at 989
    TFLOP/s once ``roofline`` divides the scaled count by the float32 rate
    (the line has no aperture, so every setting shares it); each setting's
    sandwich at 67 TFLOP/s on top; the cloud read once, which bounds the
    call: 0.84 us."""
    from portbench import roofline

    loop = harness.make_loop(harness.find_cell(ROOT, CELL), 1, "cpu")
    gram_bytes, gram_flops = loop.gram_work()
    n_bytes, flops = loop.work()
    assert gram_bytes == n_bytes == 4 * 100_000 * 7
    assert gram_flops / roofline.FP32_FLOPS_PER_S == pytest.approx(
        2 * 36 * 100_000 * 16 / 989e12, rel=1e-12)
    sandwich = (flops - gram_flops) / (256 * 16)
    assert sandwich == int(sandwich) and 0 < sandwich <= 2 * 6 * 2 * 36 + 2 * 49
    assert roofline.least_seconds(n_bytes, flops) == pytest.approx(0.8358e-6, rel=1e-3)
