"""PPO on the batched ARES-EA tuning environment (counterpart of
``examples/ppo_ares_ea.py``).

The environment steps all instances as one batch (``batched_step``): at
16,384 settings and more each step is one launch of the moment-sweep
kernel B3 on the card.  The rollout, the GAE and the PPO update stay on the
device, captured as one CUDA graph (the JAX example's one ``jax.jit``); the
host reads the loss only where it prints.

Run: python -m lynx_tpu_torch.examples.ppo_ares_ea [--updates 20]
[--num-envs 512] [--rollout 16] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import torch
from torch import nn

from lynx_tpu_torch import _collectives, graphs
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.envs.ares_ea import EnvParams, EnvState, default_params
from lynx_tpu_torch.utils import resolve_device

GAMMA, LAM, CLIP_EPS = 0.99, 0.95, 0.2
LEARNING_RATE = 3e-4


class MLPPolicy(nn.Module):
    """A tanh-Gaussian policy and value function: a tanh torso of two
    ``hidden``-wide layers, a tanh mean head, a value head and a free
    ``log_std`` starting at -0.5.  Weights are He-normal, biases zero."""

    def __init__(self, obs_size: int, act_size: int, hidden: int = 64,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.torso1 = nn.Linear(obs_size, hidden, dtype=dtype, device=device)
        self.torso2 = nn.Linear(hidden, hidden, dtype=dtype, device=device)
        self.mean = nn.Linear(hidden, act_size, dtype=dtype, device=device)
        self.value = nn.Linear(hidden, 1, dtype=dtype, device=device)
        self.log_std = nn.Parameter(torch.full((act_size,), -0.5, dtype=dtype, device=device))
        with torch.no_grad():
            for layer in (self.torso1, self.torso2, self.mean, self.value):
                n_out, n_in = layer.weight.shape
                draw = torch.randn((n_out, n_in), generator=generator, dtype=dtype,
                                   device=generator.device if generator is not None else device)
                layer.weight.copy_(draw * math.sqrt(2.0 / n_in))
                layer.bias.zero_()

    def forward(self, obs: torch.Tensor):
        """``(mean, log_std, value)`` for observations ``(..., obs_size)``."""
        h = torch.tanh(self.torso1(obs))
        h = torch.tanh(self.torso2(h))
        return torch.tanh(self.mean(h)), self.log_std, self.value(h)[..., 0]


def policy_from_jax(weights: dict, device=None) -> MLPPolicy:
    """The port's policy with the weights of the JAX example's
    ``MLPPolicy.weights`` (numpy arrays, each ``w`` stored ``(n_in,
    n_out)``; ``nn.Linear`` keeps ``(n_out, n_in)``, so ``w`` is
    transposed).  The dtype is the arrays'."""
    w = {name: {k: torch.tensor(v) for k, v in layer.items()}
         for name, layer in weights.items() if name != "log_std"}
    log_std = torch.tensor(weights["log_std"])
    obs_size, hidden = w["torso1"]["w"].shape
    policy = MLPPolicy(obs_size, log_std.shape[0], hidden, dtype=log_std.dtype,
                       device=resolve_device(device, log_std))
    with torch.no_grad():
        for name in ("torso1", "torso2", "mean", "value"):
            layer = getattr(policy, name)
            layer.weight.copy_(w[name]["w"].T)
            layer.bias.copy_(w[name]["b"])
        policy.log_std.copy_(log_std)
    return policy


def gaussian_logp(mean, log_std, action):
    """Log-density of ``action`` under the diagonal Gaussian, summed over
    the last axis."""
    return torch.sum(
        -0.5 * ((action - mean) / torch.exp(log_std)) ** 2
        - log_std
        - 0.5 * math.log(2 * math.pi),
        dim=-1,
    )


def make_collect_and_update(env, env_params: EnvParams, optimizer: torch.optim.Optimizer,
                            rollout: int, graph: bool = True):
    """Build the PPO step: a rollout of ``rollout`` batched env steps, GAE
    (gamma 0.99, lambda 0.95) and one clipped-surrogate update (epsilon
    0.2, 0.5 value loss, 0.001 entropy bonus) of ``optimizer``'s policy.

    ``collect_and_update(policy, obs, states, generator, noise=None) ->
    (obs, states, loss, mean_reward)``: the action noise is drawn from
    ``generator``, or taken from ``noise`` ``(rollout, B, act_size)``.
    After the call each parameter's ``.grad`` holds the update's gradient.

    With ``graph`` (the default) the step is the JAX example's one jitted
    program: on a CUDA policy it is captured in a CUDA graph
    (``graphs.CapturedStep``) once per policy, generator and structure of
    ``obs``, ``states`` and ``noise`` in the active mesh (the
    ``graphs.StepCache`` in ``collect_and_update.cache``), and replayed: the
    rollout's env steps (one B3 launch each at 16,384 envs and more), the
    GAE, the update's forward and backward and a capturable Adam step (the
    optimizer is set ``capturable=True``; any other optimizer raises on the
    card).  The generator is registered with the graph, so a replay draws
    the noise an eager step would; ``noise=`` captures a graph of its own.
    The warm-up's update is undone: parameters, Adam's state, the generator
    and the env states.  The returned ``obs`` and ``states`` are the graph's
    carry (a ``lax.scan`` carry): passed back as they are, the next replay
    needs no copy, and it rewrites them.  On CPU tensors the same step runs
    eagerly under ``graphs.capturing``.  ``graph=False`` runs the eager
    loop.

    Inside ``with mesh:`` on env states, observations and params split over
    the mesh's ``batch`` axis (``parallel.local_slice``), with the policy
    replicated, the update is the global one: the advantages are
    normalised, the losses and the reward averaged over every rank's
    instances, and the gradients summed over ``batch`` before the step.
    """
    step = env.batched_step

    def collect_and_update(policy: MLPPolicy, obs: torch.Tensor, states: EnvState,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None):
        group = _collectives.batch_group()
        ranks = 1 if group is None else _collectives.group_size(group)

        def global_sum(x):
            return x if group is None else _collectives.all_reduce_sum(x, group)

        def share_of_mean(x):  # this rank's part of the global mean
            return x.sum() / (x.numel() * ranks)

        traj = []
        with torch.no_grad():
            for t in range(rollout):
                mean, log_std, value = policy(obs)
                eps = (noise[t] if noise is not None else
                       torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                                   device=mean.device))
                action = mean + torch.exp(log_std) * eps
                logp = gaussian_logp(mean, log_std, action)
                next_obs, states, reward, done = step(states, action, env_params)
                traj.append((obs, action, logp, value, reward, done))
                obs = next_obs
            traj_obs, traj_act, traj_logp, traj_val, traj_rew, traj_done = (
                torch.stack(column) for column in zip(*traj)
            )

            # GAE advantages, a reverse loop on the device.
            _, _, next_value = policy(obs)
            gae = torch.zeros_like(next_value)
            advantages = []
            for t in reversed(range(rollout)):
                # Float32, as the JAX example's: gamma * lambda * not_done is
                # then float32 too (Python scalars are weak in both packages).
                not_done = 1.0 - traj_done[t].to(torch.float32)
                delta = traj_rew[t] + GAMMA * next_value * not_done - traj_val[t]
                gae = delta + GAMMA * LAM * not_done * gae
                advantages.append(gae)
                next_value = traj_val[t]
            advantages = torch.stack(advantages[::-1])
            returns = advantages + traj_val
            # The population std over every rank's instances, two-pass as
            # jnp.std.
            centre = global_sum(share_of_mean(advantages))
            spread = torch.sqrt(global_sum(share_of_mean((advantages - centre) ** 2)))
            advantages = (advantages - centre) / (spread + 1e-8)

        mean, log_std, value = policy(traj_obs)
        logp = gaussian_logp(mean, log_std, traj_act)
        ratio = torch.exp(logp - traj_logp)
        pg = -share_of_mean(torch.minimum(
            ratio * advantages,
            torch.clamp(ratio, 1 - CLIP_EPS, 1 + CLIP_EPS) * advantages,
        ))
        vf = 0.5 * share_of_mean((value - returns) ** 2)
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        # The entropy is the replicated policy's: each rank takes its share.
        loss = pg + 0.5 * vf - 0.001 * entropy / ranks

        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            _collectives.all_reduce_flat(
                [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None], group)
        if graphs.capturing():
            graphs.optimizer_step(optimizer)
        else:
            optimizer.step()
        with torch.no_grad():
            return obs, states, global_sum(loss.detach()), global_sum(share_of_mean(traj_rew))

    if not graph:
        return collect_and_update
    cache = graphs.StepCache("collect_and_update")

    def captured(policy, obs, states, generator=None, noise=None):
        step = cache((policy, generator), (obs, states, noise), lambda static, generators:
                     make_step(policy, static, generator, generators))
        new_obs, magnets, step_count, loss, reward = step()
        return (new_obs, EnvState(magnets, step_count, states.generator),
                loss.clone(), reward.clone())

    def make_step(policy, static, generator, generators):
        obs, states, noise = static
        carry = [obs, states.magnets, states.step_count]

        def run():
            new_obs, new_states, loss, reward = collect_and_update(policy, obs, states,
                                                                   generator, noise)
            # The carry, in place: the next replay starts from it.
            torch._foreach_copy_(carry, [new_obs, new_states.magnets, new_states.step_count])
            return (*carry, loss, reward)

        return graphs.CapturedStep(run, obs.device, keep=list(policy.parameters()) + carry,
                                   optimizer=optimizer, generators=generators)

    captured.cache = cache
    return captured


def main(updates: int = 20, num_envs: int = 512, rollout: int = 16, device=None,
         graph: bool = True) -> list:
    """Train for ``updates`` PPO updates; print progress every 5 and return
    the ``(loss, mean_reward)`` of each update as host floats.  With
    ``graph`` the reset and the updates run as CUDA graphs on the card (the
    JAX example's jits), and the host reads values only where it prints."""
    device = resolve_device(device)
    env = make_env(device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    env_params = default_params(generator, device=device, batch_shape=(num_envs,))
    policy = MLPPolicy(env.obs_size, env.num_actions, generator=generator, device=device)
    optimizer = torch.optim.Adam(policy.parameters(), lr=LEARNING_RATE)
    reset = graphs.graphed(env.batched_reset) if graph else env.batched_reset
    obs, states = reset(generator, env_params)
    collect_and_update = make_collect_and_update(env, env_params, optimizer, rollout, graph)

    steps_per_update = num_envs * rollout
    history = []
    start = time.perf_counter()
    for i in range(updates):
        obs, states, loss, mean_reward = collect_and_update(policy, obs, states, generator)
        history.append((loss, mean_reward))
        if i % 5 == 0 or i == updates - 1:
            loss, mean_reward = float(loss), float(mean_reward)  # waits for the update
            sps = steps_per_update * (i + 1) / (time.perf_counter() - start)
            print(f"update {i:4d}  loss {loss:9.4f}  mean reward {mean_reward:9.4f}"
                  f"  env-steps/s {sps:,.0f}")
    return [(float(loss), float(reward)) for loss, reward in history]


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--updates", type=int, default=20)
    parser.add_argument("--num-envs", type=int, default=512)
    parser.add_argument("--rollout", type=int, default=16)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args()
    main(args.updates, args.num_envs, args.rollout, args.device)
