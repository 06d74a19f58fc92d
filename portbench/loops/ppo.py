"""Traffic of PPO training on the ARES-EA environment: the program's
replayed update (``examples.ppo_ares_ea.make_collect_and_update``) called
back to back, each call fed a fresh draw of the rollout's action noise.

Set-up draws the environments' targets and incoming beams, the starting
settings and the policy's weights on the device from the seed, builds the
policy, Adam and the update, and runs the first ``check_steps`` updates
through the window's own call and feed; the reference follows them once the
window has closed."""

from __future__ import annotations

import math

import torch

from portbench import compare
from portbench.harness import Loop
from portbench.reference import lattice as lat
from portbench.reference import ppo as reference

ACTIONS = 5


def draw_inputs(cfg, B, generator, device):
    """The instances' targets, incoming beams and starting settings, and the
    policy's He-normal weights (biases zero, ``log_std`` as configured),
    float32 on ``device``."""
    env, hidden = cfg["env"], cfg["ppo"]["hidden"]

    def uniform(shape, low, high):
        u = torch.rand(shape, generator=generator, device=device)
        return low + (high - low) * u

    position = uniform((B, 2), *env["target_position"])
    size = uniform((B, 2), *env["target_size"])
    target = torch.stack([position[:, 0], size[:, 0], position[:, 1], size[:, 1]], -1)
    obs_size = ACTIONS + 4 + 4
    weights = {}
    for name, (n_in, n_out) in zip(reference.LAYERS, ((obs_size, hidden), (hidden, hidden),
                                                      (hidden, ACTIONS), (hidden, 1))):
        weights[f"{name}.weight"] = (torch.randn((n_out, n_in), generator=generator,
                                                 device=device) * math.sqrt(2.0 / n_in))
        weights[f"{name}.bias"] = torch.zeros(n_out, device=device)
    weights["log_std"] = torch.full((ACTIONS,), cfg["ppo"]["log_std"], device=device)
    return {
        "target": target,
        "incoming_mu": uniform((B, 4), *env["incoming_mu"]),
        "incoming_sigma": torch.tensor(env["incoming_sigma"], device=device).expand(B, 4),
        "magnets": uniform((B, ACTIONS), -0.5, 0.5),
        "weights": weights,
    }


def first_gradient(optimizer, p, beta1):
    """The gradient Adam took in its first step: its first moment over
    (1 - beta1); zero where it holds no state (it took none)."""
    state = optimizer.state.get(p, {})
    return state["exp_avg"].detach() / (1 - beta1) if "exp_avg" in state else torch.zeros_like(p)


def noise(traffic, generator, device):
    return torch.randn((traffic["rollout"], traffic["num_envs"], ACTIONS), generator=generator,
                       device=device)


class PPO(Loop):
    def setup(self):
        from lynx_tpu_torch.envs import make_env
        from lynx_tpu_torch.envs.ares_ea import EnvParams, EnvState
        from lynx_tpu_torch.examples import ppo_ares_ea as program

        cfg, traffic, device = self.cfg, self.traffic, self.device
        B, self.rollout = traffic["num_envs"], traffic["rollout"]
        self.units_per_call = B * self.rollout
        self.generator = torch.Generator(device=device).manual_seed(self.seed)
        self.inputs = draw_inputs(cfg, B, self.generator, device)
        self.env = make_env(device=device)
        params = EnvParams(self.inputs["target"], self.inputs["incoming_mu"],
                           self.inputs["incoming_sigma"], cfg["env"]["max_steps"])
        self.policy = program.MLPPolicy(self.env.obs_size, self.env.num_actions,
                                        cfg["ppo"]["hidden"], device=device)
        with torch.no_grad():
            for name, p in self.policy.named_parameters():
                p.copy_(self.inputs["weights"][name])
        self.optimizer = torch.optim.Adam(self.policy.parameters(),
                                          lr=cfg["ppo"]["learning_rate"])
        self.update = self.make_update(program, params)
        self.inputs["noises"] = []
        magnets = self.inputs["magnets"]
        beam = self.env.batched_beam_parameters(magnets, params)
        self.obs = torch.cat([magnets, beam * 1e3, self.inputs["target"] * 1e3], dim=-1)
        self.states = EnvState(magnets.clone(), torch.zeros(B, dtype=torch.int32, device=device),
                               None)
        self.losses = []
        start = {n: p.detach().clone() for n, p in self.policy.named_parameters()}
        for step in range(self.traffic["check_steps"]):
            self.feed()
            self.inputs["noises"].append(self.noise.clone())
            self.call()
            if step == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                first = {n: first_gradient(self.optimizer, p, beta1)
                         for n, p in self.policy.named_parameters()}
        change = {n: p.detach() - start[n] for n, p in self.policy.named_parameters()}
        self.program_result = ([float(x) for x in self.losses], first, change)
        self.losses = []

    def make_update(self, program, params):
        return program.make_collect_and_update(self.env, params, self.optimizer, self.rollout)

    def feed(self):
        self.noise = noise(self.traffic, self.generator, self.device)

    def call(self):
        self.obs, self.states, loss, _ = self.update(self.policy, self.obs, self.states,
                                                     noise=self.noise)
        self.losses.append(loss)

    def end_to_end(self, window):
        return {"env_transitions_per_s": window.calls * self.units_per_call / window.seconds}

    def failed(self):
        if self.losses is None:  # released: counted then
            return self.failures
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0

    def captures(self):
        return getattr(self.update, "cache", None)  # None: an update with no step cache

    def release(self):
        self.failures = self.failed()
        self.check_inputs = dict(self.inputs, weights={k: v.cpu() for k, v in
                                                       self.inputs["weights"].items()},
                                 noises=[n.cpu() for n in self.inputs["noises"]])
        for name in ("update", "policy", "optimizer", "env", "obs", "states", "noise", "losses",
                     "inputs"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """The set-up's draws from ``seed``, in its order: the inputs, then
        each checked update's action noise."""
        generator = torch.Generator(device=device).manual_seed(seed)
        inputs = draw_inputs(cell.cfg, cell.traffic["num_envs"], generator, device)
        inputs["noises"] = [noise(cell.traffic, generator, device)
                            for _ in range(cell.traffic["check_steps"])]
        return inputs

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        """``reference.updates``; ``fault="half_batch"`` its loss over half
        of the environments."""
        elements = lat.cell(lat.load(cell.root / cell.cfg["lattice"]), *cell.cfg["cell"])
        return reference.updates(cell.cfg, elements, inputs, inputs["noises"], dtype, device,
                                 fault=fault)

    @staticmethod
    def judge(result, truth):
        detail = {}
        return compare.training(result, truth, detail), detail


LOOP = PPO
