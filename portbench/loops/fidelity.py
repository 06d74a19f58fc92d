"""Traffic of the ARES-EA environment at particle fidelity: the program's
captured rollout (``examples.ppo_ares_ea.make_rollout``) of the PPO
example's policy called back to back, ``num_envs`` environments and
``rollout`` steps a call, each step observing one shared macro-particle
beam's sample moments at the screen for every environment's settings
(``envs.make_env(beam=..., method=...)``: kernel B6 on the card from 16
settings up, B5 below).  Each call is fed a fresh draw of the action noise;
the observations and the environments' states carry from call to call.

Set-up draws the targets, the policy's weights and the cloud on the device
from the seed, resets the environments (their settings drawn from the same
generator), runs the first ``check_steps`` calls through the window's own
feed and call, then calls on for ``warm_seconds`` (see ``setup``).  The
check, once the window has closed, follows the checked calls' rollout with
the plain reference (``reference/fidelity.py``, float64): the observations
and rewards on the program's own actions, the actions on the program's own
observations."""

from __future__ import annotations

import math
import statistics
import sys

import torch

from portbench import harness, roofline
from portbench.harness import Loop
from portbench.loops.ppo import ACTIONS
from portbench.reference import fidelity as reference
from portbench.reference import lattice as lat
from portbench.reference import optics
from portbench.reference import ppo as reference_ppo

#: The H100's dense bf16 tensor-core rate and the float32 rate outside the
#: tensor cores that ``roofline.least_seconds`` divides by (NVIDIA's H100
#: SXM data sheet).
TENSOR_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
#: The kernels' names in a graph's nodes: B6's and B5's.
GRAM_KERNEL, WALK_KERNEL = "packed_gram_kernel", "moment_walk_kernel"


def draw_inputs(cfg, B, generator, device):
    """The instances' targets, the policy's He-normal weights (biases zero,
    ``log_std`` as configured) and the shared cloud ``(N, 7)``: an
    uncorrelated Gaussian of the configured spreads about zero, the
    homogeneous column one; float32 on ``device``."""
    env, hidden, beam = cfg["env"], cfg["policy"]["hidden"], cfg["beam"]

    def uniform(shape, low, high):
        u = torch.rand(shape, generator=generator, device=device)
        return low + (high - low) * u

    position = uniform((B, 2), *env["target_position"])
    size = uniform((B, 2), *env["target_size"])
    target = torch.stack([position[:, 0], size[:, 0], position[:, 1], size[:, 1]], -1)
    weights = {}
    for name, (n_in, n_out) in zip(reference_ppo.LAYERS, ((ACTIONS + 8, hidden), (hidden, hidden),
                                                          (hidden, ACTIONS), (hidden, 1))):
        weights[f"{name}.weight"] = (torch.randn((n_out, n_in), generator=generator,
                                                 device=device) * math.sqrt(2.0 / n_in))
        weights[f"{name}.bias"] = torch.zeros(n_out, device=device)
    weights["log_std"] = torch.full((ACTIONS,), cfg["policy"]["log_std"], device=device)
    spreads = torch.tensor([beam[k] for k in ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
                                              "sigma_s", "sigma_p")], device=device)
    z = torch.randn((cfg["particles"], 6), generator=generator, device=device)
    cloud = torch.cat([z * spreads, torch.ones((cfg["particles"], 1), device=device)], dim=1)
    return {"target": target, "weights": weights, "cloud": cloud}


def noise(traffic, generator, device):
    return torch.randn((traffic["rollout"], traffic["num_envs"], ACTIONS), generator=generator,
                       device=device)


def gaps(record, truth):
    """The numbers compared: ``obs_gap``, the largest gap of an observation
    (the beam's centroid and size in units of the reference's size of that
    plane and instance; the settings and the target as they are),
    ``reward_gap`` the largest reward's gap over the reference's median
    reward, and ``action_gap`` the largest action's gap.  The dones are
    left out: they turn at ``max_steps`` (50), past the checked steps."""
    obs, ref = record["obs"].double().cpu(), truth["obs"].double().cpu()
    scale = torch.ones_like(ref)
    for columns, size in (((5, 6), 6), ((7, 8), 8)):
        for column in columns:
            scale[..., column] = ref[..., size]
    rewards, ref_rewards = record["rewards"].double().cpu(), truth["rewards"].double().cpu()
    return {
        "obs_gap": float(torch.max(torch.abs(obs - ref) / scale)),
        "reward_gap": float(torch.max(torch.abs(rewards - ref_rewards))
                            / statistics.median(ref_rewards.abs().flatten().tolist())),
        "action_gap": float(torch.max(torch.abs(record["actions"].double().cpu()
                                                - truth["actions"].double().cpu()))),
    }


class Fidelity(Loop):
    def setup(self):
        from lynx_tpu_torch import graphs
        from lynx_tpu_torch.envs import make_env
        from lynx_tpu_torch.envs.ares_ea import EnvParams
        from lynx_tpu_torch.examples import ppo_ares_ea as program
        from lynx_tpu_torch.ops import fused_track
        from lynx_tpu_torch.particles import ParticleBeam

        cfg, traffic, device = self.cfg, self.traffic, self.device
        B, self.rollout = traffic["num_envs"], traffic["rollout"]
        self.units_per_call = B * self.rollout
        self.generator = torch.Generator(device=device).manual_seed(self.seed)
        inputs = draw_inputs(cfg, B, self.generator, device)
        beam = ParticleBeam(inputs["cloud"], torch.tensor(cfg["energy_ev"], device=device))
        self.env = make_env(device=device, beam=beam, method=cfg["observation"]["method"])
        unused = torch.zeros((B, 4), device=device)  # the ParameterBeam's: a beam is given
        params = EnvParams(inputs["target"], unused, unused, cfg["env"]["max_steps"])
        self.policy = program.MLPPolicy(self.env.obs_size, self.env.num_actions,
                                        cfg["policy"]["hidden"], device=device)
        with torch.no_grad():
            for name, p in self.policy.named_parameters():
                p.copy_(inputs["weights"][name])
        self.fn = program.make_rollout(self.env, params, self.rollout)
        self.obs, self.states = self.env.batched_reset(self.generator, params)
        def counts():
            return (fused_track.packed_gram.launches, fused_track.particle_moment_sweep.launches,
                    fused_track.sweep_particle_moments.particle_settings, self.fn.runs)

        before, self.rewards, calls = counts(), [], []
        for _ in range(traffic["check_steps"]):
            self.feed()
            self.call()
            calls.append(self.traj)
        b6, b5, settings, runs = (now - then for now, then in zip(counts(), before))
        obs, actions, rewards, _ = (list(column) for column in zip(*calls))
        self.program_result = {"obs": torch.cat(obs + [self.obs[None].clone()]),
                               "actions": torch.cat(actions), "rewards": torch.cat(rewards)}
        self.check_inputs = self.draw_check_inputs(self.cell, self.seed, device)
        graph = harness.replayed_graph(self)
        nodes = "no graph (eager)" if graph is None else (
            f"{graphs.graph_kernel_count(graph, GRAM_KERNEL)} B6 and"
            f" {graphs.graph_kernel_count(graph, WALK_KERNEL)} B5 kernel nodes")
        print(f"a call: {b6 / runs:g} B6 launches, {b5 / runs:g} B5 launches, {settings / runs:.0f}"
              f" particle-settings ({self.rollout} steps x {B} settings x {cfg['particles']}"
              f" particles); the replayed graph holds {nodes}", file=sys.stderr, flush=True)
        # The card's steady state under this load before the window: an H100
        # runs each of a replay's small kernels ~1.3 times as long for the
        # first seconds of a process and leaves that state at a random time
        # (within 10 s of calls in about four processes of five; one of about
        # 70 was still in it after 18 s): the rate rises from ~91 to ~118 k
        # transitions/s.  The SM clock reads 1980 MHz in both states.
        harness.run_window(self, seconds=traffic["warm_seconds"])
        self.rewards = []

    def feed(self):
        self.noise = noise(self.traffic, self.generator, self.device)

    def call(self):
        self.traj, self.obs, self.states = self.fn(self.policy, self.obs, self.states, self.noise)
        self.rewards.append(self.traj[2])

    def end_to_end(self, window):
        return {"env_transitions_per_s": window.calls * self.units_per_call / window.seconds}

    def failed(self):
        if self.rewards is None:  # released: counted then
            return self.failures
        if not self.rewards:
            return 0
        return int((~torch.isfinite(torch.stack(self.rewards)).flatten(1).all(dim=1)).sum())

    def captures(self):
        return self.fn.cache

    def gram_work(self):
        """``(bytes, flops)`` of the moments' Gram a call: the cloud ``(N, 7)``
        read once, and one Gram of it at each step, 36 multiply-adds a
        particle.  The cell holds no aperture (the reference takes none that
        cuts the beam), so every setting's survival mask is one and a single
        Gram serves all of a step's settings; only a line with apertures
        needs one a setting.  Counted at the H100's dense bf16 tensor-core
        rate (a float Gram of three bf16 parts at the float32 rate could read
        over 100%), passed scaled by 67/989 because
        ``roofline.least_seconds`` divides by the float32 rate."""
        n = self.cfg["particles"]
        flops = 2 * 36 * n * self.traffic["rollout"]
        return 4 * n * 7, flops * FP32_FLOPS_PER_S / TENSOR_FLOPS_PER_S

    def work(self):
        """``(bytes, flops)`` of a call: :meth:`gram_work`, and at each step
        every setting's sandwich of the Gram by the line's map, on the map's
        support (``roofline.sandwich_flops``).  The maps' building, the
        centre and the policy are left out."""
        cfg = self.cfg
        tuned = {name: i for i, name in enumerate(cfg["env"]["tuned"])}
        line = optics.Line(lat.cell(lat.load(self.lattice_path), *cfg["cell"]), cfg["energy_ev"],
                           tuned, torch.float64, "cpu")
        generator = torch.Generator().manual_seed(0)
        settings = ((0.5 + torch.rand((2, len(tuned)), generator=generator, dtype=torch.float64))
                    * torch.tensor(cfg["env"]["magnet_limits"], dtype=torch.float64))
        sandwich = roofline.sandwich_flops(roofline.support(line.total(settings)))
        n_bytes, flops = self.gram_work()
        settings_a_call = self.traffic["num_envs"] * self.traffic["rollout"]
        return n_bytes, flops + settings_a_call * sandwich

    def release(self):
        self.failures = self.failed()
        for name in ("fn", "policy", "env", "obs", "states", "noise", "traj", "rewards"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """The set-up's draws from ``seed``, in its order: the inputs, the
        reset's settings ``(B, 5)`` uniform in [-0.5, 0.5) as the
        environment's ``batched_reset`` draws them, then each checked call's
        action noise."""
        generator = torch.Generator(device=device).manual_seed(seed)
        B = cell.traffic["num_envs"]
        inputs = draw_inputs(cell.cfg, B, generator, device)
        inputs["magnets"] = torch.rand((B, ACTIONS), generator=generator, device=device) - 0.5
        inputs["noises"] = [noise(cell.traffic, generator, device)
                            for _ in range(cell.traffic["check_steps"])]
        return inputs

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        """``reference.Reference``: in float64 without a fault, the truth
        that follows a rollout; else the reference's own rollout, run now
        (in the control's TF32 context, with the fault)."""
        made = reference.Reference(cell.cfg, cell.root / cell.cfg["lattice"], inputs, dtype,
                                   device, fault, cell.traffic["reference_block"])
        if dtype != torch.float64 or fault is not None:
            made.record
        return made

    @staticmethod
    def judge(result, truth):
        record = getattr(result, "record", result)
        return gaps(record, truth.follow(record)), {}


LOOP = Fidelity
