"""Plain PPO on the ARES-EA tuning task: the environment's physics (the EA
line's moments at the screen), the tanh-Gaussian policy, the rollout with
given action noise, GAE, the clipped-surrogate loss and Adam, written from
their definitions (Schulman et al. 2017, "Proximal Policy Optimization
Algorithms"; Kingma and Ba 2015, "Adam"), with no code of the program.

Each update's loss is the loss of the batch collected with the policy as it
stood before that update, as in the program's step."""

from __future__ import annotations

import math

import torch

from portbench.reference import optics
from portbench.reference.precision import matmul

LAYERS = ("torso1", "torso2", "mean", "value")


class Env:
    """The batched ARES-EA environment: settings ``(B, 5)`` normalised to
    [-1, 1] (k1 of the three quadrupoles, the vertical and the horizontal
    corrector's angle) scaled by ``limits``; the observation is the
    settings, the beam ``(mu_x, sigma_x, mu_y, sigma_y)`` at the screen and
    the target, both in mm; the reward minus their L1 distance in mm."""

    def __init__(self, cfg, elements, inputs, dtype, device):
        env = cfg["env"]
        tuned = {name: i for i, name in enumerate(env["tuned"])}
        self.line = optics.Line(elements, cfg["energy_ev"], tuned, dtype, device)
        self.limits = torch.tensor(env["magnet_limits"], dtype=torch.float32).to(dtype).to(device)
        self.target = inputs["target"].to(dtype)
        self.mu, self.cov = optics.gaussian(
            inputs["incoming_mu"], inputs["incoming_sigma"], env["incoming_sigma_s"],
            env["incoming_sigma_p"], dtype, device)
        self.max_steps = env["max_steps"]

    def beam(self, magnets):
        mu, cov = self.line.moments(magnets * self.limits, self.mu, self.cov)
        return torch.stack([mu[:, 0], optics.sigma(cov, 0), mu[:, 2], optics.sigma(cov, 2)], -1)

    def observe(self, magnets, beam):
        return torch.cat([magnets, beam * 1e3, self.target * 1e3], dim=-1)

    def step(self, magnets, step_count, action):
        magnets = torch.clamp(action, -1.0, 1.0)
        step_count = step_count + 1
        beam = self.beam(magnets)
        reward = -torch.sum(torch.abs(beam - self.target), dim=-1) * 1e3
        return magnets, step_count, self.observe(magnets, beam), reward, step_count >= self.max_steps


def policy(weights, obs):
    """``(mean, log_std, value)`` of the tanh MLP ``weights``
    (``{layer}.weight`` ``(out, in)``, ``{layer}.bias``, ``log_std``)."""
    def linear(name, x):
        w, b = weights[f"{name}.weight"], weights[f"{name}.bias"]
        return matmul(x, w.transpose(0, 1)) + b

    h = torch.tanh(linear("torso1", obs))
    h = torch.tanh(linear("torso2", h))
    return torch.tanh(linear("mean", h)), weights["log_std"], linear("value", h)[..., 0]


def logp(mean, log_std, action):
    return torch.sum(-0.5 * ((action - mean) / torch.exp(log_std)) ** 2 - log_std
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def adam(weights, grads, state, t, lr, betas=(0.9, 0.999), eps=1e-8):
    """One Adam step on ``weights`` in place; ``state`` holds m and v."""
    b1, b2 = betas
    with torch.no_grad():
        for name, g in grads.items():
            m, v = state.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1**t)
            v_hat = v / (1 - b2**t)
            weights[name].sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))


def updates(cfg, elements, inputs, noises, dtype, device, fault=None):
    """Run ``len(noises)`` PPO updates from ``inputs`` (``target``,
    ``incoming_mu``, ``incoming_sigma``, ``magnets``, ``weights``; the
    rollout's action noise ``noises[k]`` ``(rollout, B, 5)``).

    Returns ``(losses, first_gradient, change)``: each update's loss, the
    first update's gradient and the weights' change over all updates, by
    weight name.  ``fault="half_batch"`` takes the loss over the first half
    of the instances only (a planted fault)."""
    ppo = cfg["ppo"]
    gamma, lam, clip = ppo["gamma"], ppo["lambda"], ppo["clip"]
    env = Env(cfg, elements, inputs, dtype, device)
    weights = {k: v.to(device=device, dtype=dtype).clone().requires_grad_(True)
               for k, v in inputs["weights"].items()}
    start = {k: v.detach().clone() for k, v in weights.items()}
    magnets = inputs["magnets"].to(device=device, dtype=dtype)
    step_count = torch.zeros(magnets.shape[:1], dtype=torch.int64, device=device)
    obs = env.observe(magnets, env.beam(magnets))
    state, losses, first = {}, [], None
    for k, noise in enumerate(noises):
        noise = noise.to(device=device, dtype=dtype)
        columns = []
        with torch.no_grad():
            for t in range(noise.shape[0]):
                mean, log_std, value = policy(weights, obs)
                action = mean + torch.exp(log_std) * noise[t]
                magnets, step_count, next_obs, reward, done = env.step(magnets, step_count, action)
                columns.append((obs, action, logp(mean, log_std, action), value, reward, done))
                obs = next_obs
            t_obs, t_act, t_logp, t_val, t_rew, t_done = (torch.stack(c) for c in zip(*columns))
            if fault == "half_batch":
                half = t_obs.shape[1] // 2
                t_obs, t_act, t_logp, t_val, t_rew, t_done = (
                    x[:, :half] for x in (t_obs, t_act, t_logp, t_val, t_rew, t_done))
                last_obs = obs[:half]
            else:
                last_obs = obs
            next_value = policy(weights, last_obs)[2]
            gae, advantages = torch.zeros_like(next_value), []
            for t in reversed(range(noise.shape[0])):
                not_done = 1.0 - t_done[t].to(dtype)
                delta = t_rew[t] + gamma * next_value * not_done - t_val[t]
                gae = delta + gamma * lam * not_done * gae
                advantages.append(gae)
                next_value = t_val[t]
            advantages = torch.stack(advantages[::-1])
            returns = advantages + t_val
            centre = advantages.mean()
            spread = torch.sqrt(((advantages - centre) ** 2).mean())
            advantages = (advantages - centre) / (spread + 1e-8)
        mean, log_std, value = policy(weights, t_obs)
        ratio = torch.exp(logp(mean, log_std, t_act) - t_logp)
        pg = -torch.minimum(ratio * advantages,
                            torch.clamp(ratio, 1 - clip, 1 + clip) * advantages).mean()
        vf = 0.5 * ((value - returns) ** 2).mean()
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = pg + ppo["value_coef"] * vf - ppo["entropy_coef"] * entropy
        grads = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
        if first is None:
            first = {name: g.detach().clone() for name, g in grads.items()}
        adam(weights, grads, state, k + 1, ppo["learning_rate"])
        losses.append(float(loss.detach()))
    change = {name: (w.detach() - start[name]) for name, w in weights.items()}
    return losses, first, change
