"""The ARES-EA environment at particle fidelity, plain: one shared cloud of
macro-particles, every particle pushed through the EA line for each
instance's settings (the line's 7x7 map composed per setting), and the
sample moments ``(mu_x, sigma_x, mu_y, sigma_y)`` at the screen as the
observation; the policy of ``reference.ppo`` acts.  Written from the
definitions, with no code of the program.

:class:`Reference` runs the rollout itself (:attr:`Reference.record`: the
reference put in the program's place, in its dtype, with a planted fault)
and follows a given rollout (:meth:`Reference.follow`): on that rollout's
own actions it gives the observations and rewards the environment yields,
and on its own observations the actions the policy takes, so that a
policy's rounding does not compound over the steps.

The faults it knows: ``half_batch`` (the moments of the first half of
the cloud), ``stale`` (each step observes the previous step's settings) and
``other_env`` (each instance observes the next instance's settings)."""

from __future__ import annotations

import functools

import torch

from portbench.reference import lattice as lat
from portbench.reference import optics, ppo
from portbench.reference.precision import matmul

FAULTS = ("half_batch", "stale", "other_env")


class Reference:
    """The rollouts of ``inputs`` (``target`` ``(B, 4)``, ``magnets`` ``(B,
    5)`` at the reset, the policy's ``weights``, the shared ``cloud`` ``(N,
    7)`` and each call's action ``noises`` ``(rollout, B, 5)``) in
    ``dtype``; the settings are pushed ``block`` at a time."""

    def __init__(self, cfg, lattice_path, inputs, dtype, device, fault=None, block=16):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r} ({', '.join(FAULTS)})")
        # Full float32 products where the reference runs in float32: the
        # control's TF32 is rounded by ``precision`` itself, never by cuBLAS.
        torch.backends.cuda.matmul.allow_tf32 = False
        env = cfg["env"]
        elements = lat.cell(lat.load(lattice_path), *cfg["cell"])
        tuned = {name: i for i, name in enumerate(env["tuned"])}
        self.line = optics.Line(elements, cfg["energy_ev"], tuned, dtype, device)
        self.limits = torch.tensor(env["magnet_limits"], dtype=torch.float32).to(dtype).to(device)
        self.inputs, self.dtype, self.device = inputs, dtype, device
        self.fault, self.block = fault, block
        self.target = inputs["target"].to(device=device, dtype=dtype)
        cloud = inputs["cloud"].to(device=device, dtype=dtype)
        self.cloud = cloud[: cloud.shape[0] // 2] if fault == "half_batch" else cloud
        self.weights = {k: v.to(device=device, dtype=dtype) for k, v in inputs["weights"].items()}

    def beam(self, magnets):
        """``(B, 4)`` sample ``(mu_x, sigma_x, mu_y, sigma_y)`` of the cloud
        at the screen for ``(B, 5)`` normalised settings (Bessel's ``N - 1``
        in the variance)."""
        settings = magnets.to(self.dtype) * self.limits
        n = self.cloud.shape[0]
        out = []
        for lo in range(0, settings.shape[0], self.block):
            pushed = matmul(self.line.total(settings[lo:lo + self.block]), self.cloud.t())
            mu = pushed.mean(dim=-1)
            var = ((pushed - mu[..., None]) ** 2).sum(dim=-1) / (n - 1)
            out.append(torch.stack([mu[:, 0], torch.sqrt(var[:, 0]), mu[:, 2],
                                    torch.sqrt(var[:, 2])], dim=-1))
        return torch.cat(out)

    def observe(self, magnets, beam):
        target = torch.broadcast_to(self.target, beam.shape)
        return torch.cat([magnets, beam * 1e3, target * 1e3], dim=-1)

    def reward(self, beam):
        return -torch.sum(torch.abs(beam - self.target), dim=-1) * 1e3

    def act(self, obs, noise):
        mean, log_std, _ = ppo.policy(self.weights, obs)
        return mean + torch.exp(log_std) * noise

    def noise(self):
        return torch.cat([n.to(device=self.device, dtype=self.dtype)
                          for n in self.inputs["noises"]])

    @functools.cached_property
    def record(self):
        """The rollout over every call's noise, run by the reference:
        ``{obs (S + 1, B, 13), actions (S, B, 5), rewards (S, B)}`` over the
        S steps, ``obs[0]`` the reset's."""
        magnets = self.inputs["magnets"].to(device=self.device, dtype=self.dtype)
        obs = [self.observe(magnets, self.beam(magnets))]
        actions, rewards = [], []
        for noise in self.noise():
            action = self.act(obs[-1], noise)
            previous, magnets = magnets, torch.clamp(action, -1.0, 1.0)
            seen = {"stale": previous, "other_env": torch.roll(magnets, 1, dims=0)}.get(
                self.fault, magnets)
            beam = self.beam(seen)
            obs.append(self.observe(magnets, beam))
            actions.append(action)
            rewards.append(self.reward(beam))
        return {"obs": torch.stack(obs), "actions": torch.stack(actions),
                "rewards": torch.stack(rewards)}

    def follow(self, record):
        """What the environment and the policy give on ``record``'s rollout:
        the observations after each of its actions (``obs[0]`` the reset's,
        of ``inputs["magnets"]``), the rewards, and the policy's action on
        each of its observations, in the same layout."""
        actions = record["actions"].to(device=self.device, dtype=self.dtype)
        seen = record["obs"][:-1].to(device=self.device, dtype=self.dtype)
        reset = self.inputs["magnets"].to(device=self.device, dtype=self.dtype)
        magnets = torch.cat([reset[None], torch.clamp(actions, -1.0, 1.0)])
        beams = torch.stack([self.beam(m) for m in magnets])
        return {"obs": self.observe(magnets, beams),
                "actions": self.act(seen, self.noise()),
                "rewards": self.reward(beams[1:])}
