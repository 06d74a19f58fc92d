"""The comparison that decides ``correct``, shown to fail: runs at small
sizes on the CPU with the timed path broken underneath (each fault the cell
can have: a step that leaves its state unchanged, half of the batch left out
with the mean over the rest, an answer altered where it is produced; the
exchange between chips has no place on one chip), and the control: the
plain reference put in the program's place in TF32, the precision below the
float32 the configurations state."""

import json

import pytest
import torch

from conftest import ROOT, SMALL
from portbench import compare, harness
from portbench.run import run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
PPO = ["ares_ea.ppo_100k"]


def run(name):
    return run_cell(ROOT, name, 2**31 + 5, 0.3, 0, device="cpu", overrides=SMALL[name],
                    log=lambda message: None)


def no_step(*args, **kwargs):
    """An optimizer step that leaves the parameters as they are."""


@pytest.mark.parametrize("name", PPO + ["ares_full.tune_100k"])
def test_a_step_that_leaves_its_state_unchanged_fails(name, monkeypatch):
    from lynx_tpu_torch import graphs, tuning

    monkeypatch.setattr(graphs, "optimizer_step", no_step)
    monkeypatch.setattr(tuning, "optimizer_step", no_step)
    result = run(name)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", PPO)
def test_ppo_on_half_of_the_batch_fails(name, monkeypatch):
    from lynx_tpu_torch.envs.ares_ea import EnvParams, EnvState
    from portbench.loops import ppo

    def half_update(self, program, params):
        """The update of the first half of the environments only: the loss,
        the reward and the gradient are means over them."""
        half = params.target.shape[0] // 2
        inner = program.make_collect_and_update(
            self.env, EnvParams(params.target[:half], params.incoming_mu[:half],
                                params.incoming_sigma[:half], params.max_steps),
            self.optimizer, self.rollout)

        def update(policy, obs, states, noise):
            new_obs, new_states, loss, reward = inner(
                policy, obs[:half], EnvState(states.magnets[:half], states.step_count[:half],
                                             None), noise=noise[:, :half])
            magnets = torch.cat([new_states.magnets, states.magnets[half:]])
            count = torch.cat([new_states.step_count, states.step_count[half:]])
            return (torch.cat([new_obs, obs[half:]]), EnvState(magnets, count, None), loss,
                    reward)

        return update

    monkeypatch.setattr(ppo.PPO, "make_update", half_update)
    assert not run(name)["correct"]


def test_tune_on_half_of_the_settings_fails(monkeypatch):
    from portbench.loops import tune

    def half_loss(outgoing):
        half = outgoing.sigma_x.shape[0] // 2
        return 2 * torch.sum(outgoing.mu_x[:half].abs() + outgoing.sigma_x[:half]
                             + outgoing.mu_y[:half].abs() + outgoing.sigma_y[:half])

    monkeypatch.setattr(tune, "loss_of", half_loss)
    assert not run("ares_full.tune_100k")["correct"]


def broken_read(monkeypatch, fault):
    """``functional.track_jit`` with ``fault`` planted in its image."""
    from lynx_tpu_torch import functional
    from lynx_tpu_torch.particles import ParticleBeam

    real = functional.track_jit.graphed
    first = {}

    def track_jit(segment, beam):
        if fault == "half_batch":
            half = beam.particles.shape[-2] // 2
            beam = ParticleBeam(beam.particles[..., :half, :], beam.energy)
        out, readings = real(segment, beam)
        readings = dict(readings)
        image = readings["AREABSCR1"]
        if fault == "half_batch":
            image = 2 * image
        elif fault == "stale":
            image = first.setdefault("image", image)
        elif fault == "altered":
            image = image.clone()
            image[..., 0, 0] += 2000
        readings["AREABSCR1"] = image
        return out, readings

    track_jit.graphed = real
    monkeypatch.setattr(functional, "track_jit", track_jit)


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
def test_a_broken_screen_read_fails(fault, monkeypatch):
    broken_read(monkeypatch, fault)
    result = run("ares_ea.screen_b1")
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["tf32", "half_batch"])
def test_the_control_and_the_planted_fault_fail_the_limits(name, kind):
    cell = harness.find_cell(ROOT, name, SMALL[name])
    numbers, _ = harness.control(cell, 2**31 + 9, "cpu", kind)
    correct, checks = compare.verdict(numbers, cell.limits)
    assert not correct, checks
