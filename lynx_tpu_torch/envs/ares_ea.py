"""ARES-EA transverse beam-tuning environment (counterpart of
``lynx_tpu.envs.ares_ea``).

Tune the 3 quadrupoles and 2 correctors of the ARES Experimental Area so
that the beam hits a target position and size on the AREABSCR1 screen.  The
environment is functional (``reset`` / ``step`` over an explicit
``EnvState``), and its batched methods track B settings at once: at large B
a ParameterBeam run takes the fused moment sweep (kernel B3 on the card,
B4 for its gradient), and the particle observation's ``method="kernel"``
the particle moment sweep (kernels B5 and B6).

Action: 5 settings ``(k1_Q1, k1_Q2, k1_Q3, angle_CV, angle_CH)``, normalised
to [-1, 1].  Observation: the settings, the beam ``(mu_x, sigma_x, mu_y,
sigma_y)`` on the screen and the target, both in mm.  Reward: minus the
L1 distance between beam and target, in mm.

Randomness comes from ``torch.Generator``s where the JAX package splits
PRNG keys: one generator serves a whole batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lynx_tpu_torch.accelerator.fused import particle_moment_plan
from lynx_tpu_torch.accelerator.segment import Segment
from lynx_tpu_torch.functional import moment_sufficient, track
from lynx_tpu_torch.graphs import graphed
from lynx_tpu_torch.models import ares_ea_segment
from lynx_tpu_torch.ops.fused_track import sweep_particle_moments
from lynx_tpu_torch.particles import ParameterBeam, ParticleBeam
from lynx_tpu_torch.utils import resolve_device

Tensor = torch.Tensor

#: Action scaling: max |k1| for quads (1/m^2), max |angle| for correctors
#: (rad).  Float32, as in the JAX package, so that both scale alike.
MAGNET_LIMITS = np.array([30.0, 30.0, 30.0, 6e-3, 6e-3], dtype=np.float32)


class EnvParams(NamedTuple):
    """Per-instance environment configuration (leading ``(B,)`` axis in
    the batched methods).  The working-point energy lives on the
    environment, not here: a per-instance energy would batch the energy
    through every map builder and stop the fused sweep from hoisting the
    static elements (``accelerator/fused.plan_run``)."""

    target: Tensor  # (4,) target (mu_x, sigma_x, mu_y, sigma_y) on the screen
    incoming_mu: Tensor  # (4,) incoming beam (mu_x, mu_xp, mu_y, mu_yp)
    incoming_sigma: Tensor  # (4,) incoming (sigma_x, sigma_xp, sigma_y, sigma_yp)
    max_steps: int = 50


class EnvState(NamedTuple):
    magnets: Tensor  # (5,) current settings, normalised to [-1, 1]
    step_count: Tensor  # () int32
    generator: torch.Generator


def default_params(
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    batch_shape: Tuple[int, ...] = (),
) -> EnvParams:
    """Randomised-target default parameters (the ARES-EA task): a target
    position in [-2, 2] mm, a target size in [0.01, 1] mm and an incoming
    offset in [-0.1, 0.1] mm, drawn from ``generator`` (seed 0 on the CPU if
    None) for each of ``batch_shape`` instances (the JAX package vmaps its
    ``default_params`` over keys instead).  They live on ``device``; without
    it, on the generator's device if one is given, else on the card."""
    if device is None and generator is not None:
        device = generator.device
    device = resolve_device(device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def uniform(shape, low, high):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (low + (high - low) * u).to(device)

    target_pos = uniform((*batch_shape, 2), -2e-3, 2e-3)
    target_size = uniform((*batch_shape, 2), 1e-5, 1e-3)
    target = torch.stack(
        [target_pos[..., 0], target_size[..., 0], target_pos[..., 1], target_size[..., 1]], dim=-1
    )
    sigma = torch.tensor([1.75e-4, 2e-5, 1.75e-4, 2e-5], dtype=dtype, device=device)
    return EnvParams(
        target=target,
        incoming_mu=uniform((*batch_shape, 4), -1e-4, 1e-4),
        incoming_sigma=sigma.expand(*batch_shape, 4),
    )


class AresEATransverseTuning:
    """Functional ARES-EA tuning environment over ParameterBeam physics.

    :param log_metrics: log each step's beam statistics and reward.
    :param energy: working-point beam energy in eV, shared by all instances.
    :param dtype, device: of the lattice and of the beams it builds; the
        device is the card unless given.
    """

    num_actions = 5
    obs_size = 5 + 4 + 4  # magnets + current beam params + target

    def __init__(
        self,
        log_metrics: bool = False,
        energy: float = 1.073e8,
        dtype: torch.dtype = torch.float32,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        segment = ares_ea_segment(dtype=dtype, device=self.device)
        segment.AREABSCR1.is_active = False
        self._segment = segment
        self.energy = float(energy)
        #: When True, every (batched) step logs the beam on the screen and
        #: the reward (means over the batch) through ``lynx_tpu_torch.metrics``,
        #: at the cost of one device sync a step.
        self.log_metrics = log_metrics
        self.dtype = dtype
        self._limits = torch.from_numpy(MAGNET_LIMITS).to(dtype=dtype, device=self.device)

    # -- physics -----------------------------------------------------------
    def _tuned_segment(self, settings: Tensor, batch: Optional[int]) -> Segment:
        """The EA segment with the 5 tuned magnets set to ``settings``
        (``(5,)``, or ``(B, 5)`` with ``batch = B``).  Batched, the tuned
        elements' lengths broadcast to ``(B,)`` too, which is what makes the
        run batched; the other elements stay at ``(1,)`` and hoist."""
        fields = {
            "AREAMQZM1": ("k1", 0),
            "AREAMQZM2": ("k1", 1),
            "AREAMQZM3": ("k1", 2),
            "AREAMCVM1": ("angle", 3),
            "AREAMCHM1": ("angle", 4),
        }
        elements = []
        for element in self._segment.elements:
            if element.name in fields:
                field, column = fields[element.name]
                if batch is None:
                    element = element.replace(**{field: settings[column][None]})
                else:
                    element = element.replace(
                        length=torch.broadcast_to(element.length, (batch,)),
                        **{field: settings[:, column]},
                    )
            elements.append(element)
        return Segment(elements, name=self._segment.name)

    def _incoming(self, mu: Tensor, sigma: Tensor) -> ParameterBeam:
        """The incoming beam, re-wrapped with the unbatched working-point
        energy (``from_parameters`` broadcasts the energy to the batch, which
        would stop the fused sweep from hoisting the static elements)."""
        beam = ParameterBeam.from_parameters(
            mu_x=mu[..., 0], mu_xp=mu[..., 1], mu_y=mu[..., 2], mu_yp=mu[..., 3],
            sigma_x=sigma[..., 0], sigma_xp=sigma[..., 1],
            sigma_y=sigma[..., 2], sigma_yp=sigma[..., 3],
            dtype=self.dtype, device=self.device,
        )
        energy = torch.full((1,), self.energy, dtype=self.dtype, device=self.device)
        return ParameterBeam(beam._mu, beam._cov, energy=energy)

    def beam_parameters(self, magnets: Tensor, params: EnvParams) -> Tensor:
        """Track the incoming beam for ``(5,)`` settings and return
        ``(mu_x, sigma_x, mu_y, sigma_y)`` at the screen."""
        tuned = self._tuned_segment(magnets * self._limits, batch=None)
        beam = self._incoming(params.incoming_mu[None], params.incoming_sigma[None])
        outgoing, _ = track(tuned, beam)
        return torch.stack(
            [outgoing.mu_x[0], outgoing.sigma_x[0], outgoing.mu_y[0], outgoing.sigma_y[0]]
        )

    def _batched_tuned_segment(self, magnets: Tensor) -> Segment:
        """The EA segment with the 5 tuned magnets set from ``(B, 5)``
        normalised settings."""
        return self._tuned_segment(magnets * self._limits, batch=magnets.shape[0])

    def batched_beam_parameters(self, magnets: Tensor, params: EnvParams) -> Tensor:
        """:meth:`beam_parameters` for ``(B, 5)`` settings and batched
        ``EnvParams``, tracked as one batch: ``(B, 4)``."""
        tuned = self._batched_tuned_segment(magnets)
        beam = self._incoming(params.incoming_mu, params.incoming_sigma)
        outgoing, _ = track(tuned, beam)
        return torch.stack(
            [outgoing.mu_x, outgoing.sigma_x, outgoing.mu_y, outgoing.sigma_y], dim=-1
        )

    def batched_particle_beam_parameters(
        self, magnets: Tensor, beam: ParticleBeam, method: str = "auto"
    ) -> Tensor:
        """Observation of a macro-particle beam: ``(B, 4)`` sample-moment
        ``(mu_x, sigma_x, mu_y, sigma_y)`` at the screen for ``(B, 5)``
        settings; the incoming beam broadcasts against the settings.

        :param method: ``"moments"`` tracks the beam's sample moments
            (``beam.as_parameter_beam()``), exact for a linear lattice;
            ``"particles"`` pushes every particle for every setting;
            ``"auto"`` takes ``"moments"`` when the lattice is moment
            sufficient (the EA with its screen inactive is), else
            ``"particles"``; ``"kernel"`` runs the particle moment sweep of
            the shared cloud (kernels B5/B6 on the card), which also serves
            lattices with interleaved active apertures.
        """
        tuned = self._batched_tuned_segment(magnets)
        if method == "auto":
            method = "moments" if moment_sufficient(tuned, beam) else "particles"
        if method == "moments":
            outgoing, _ = track(tuned, beam.as_parameter_beam())
        elif method == "particles":
            outgoing, _ = track(tuned, beam)
        elif method == "kernel":
            return self._kernel_particle_beam_parameters(magnets, tuned, beam)
        else:
            raise ValueError(f"unknown method {method!r} (auto | moments | kernel | particles)")
        return torch.stack(
            [outgoing.mu_x, outgoing.sigma_x, outgoing.mu_y, outgoing.sigma_y], dim=-1
        )

    def _kernel_particle_beam_parameters(
        self, magnets: Tensor, tuned: Segment, beam: ParticleBeam
    ) -> Tensor:
        """Particle-fidelity observation through the settings-amortized
        moment sweep (``ops/fused_track.sweep_particle_moments``): the B
        settings walk one shared cloud, and interleaved active apertures
        (per-particle survival that no moment algebra expresses) are
        supported."""
        B = magnets.shape[0]
        particles = beam.particles
        plan = particle_moment_plan(
            tuned.flattened().elements,
            # Pin the energy to the particles' dtype: self.energy is a Python
            # float and would otherwise promote the plan to float64.  Filled
            # on the device: a capture refuses a host-to-device copy.
            torch.full((), self.energy, dtype=particles.dtype, device=particles.device),
            lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
        )
        if plan is None:
            raise ValueError("kernel method requires an affine-plus-apertures lattice")
        if particles.ndim == 3 and particles.shape[0] == 1:
            particles = particles[0]
        if particles.ndim != 2:
            raise ValueError("kernel method requires one shared (unbatched) beam")
        weights = (
            torch.ones(particles.shape[:1], dtype=particles.dtype, device=particles.device)
            if beam.survival is None
            else beam.survival.reshape(particles.shape[:1])
        )
        entries, scalars = plan
        mu, cov, _ = sweep_particle_moments(entries, scalars, particles, weights, batch_size=B)
        return torch.stack(
            [mu[:, 0], torch.sqrt(cov[:, 0, 0]), mu[:, 2], torch.sqrt(cov[:, 2, 2])], dim=-1
        )

    def _observe(self, magnets: Tensor, beam: Tensor, target: Tensor) -> Tensor:
        return torch.cat([magnets, beam * 1e3, target * 1e3], dim=-1)

    def _emit_metrics(self, beam: Tensor, rewards: Tensor, step_count: Tensor) -> None:
        """The step's metric line: the beam on the screen and the reward,
        means over any batch, at the first instance's step count."""
        from lynx_tpu_torch.metrics import emit_metrics

        names = ("mu_x", "sigma_x", "mu_y", "sigma_y")
        metrics = {name: torch.mean(beam[..., i]) for i, name in enumerate(names)}
        metrics["reward"] = torch.mean(rewards)
        emit_metrics(metrics, step=step_count)

    def batched_step(
        self, states: EnvState, actions: Tensor, params: EnvParams
    ) -> Tuple[Tensor, EnvState, Tensor, Tensor]:
        """:meth:`step` over ``(B, ...)`` states, actions and params, tracked
        as one batch."""
        magnets = torch.clamp(actions, -1.0, 1.0)
        next_states = EnvState(magnets, states.step_count + 1, states.generator)
        beam = self.batched_beam_parameters(magnets, params)
        rewards = -torch.sum(torch.abs(beam - params.target), dim=-1) * 1e3
        dones = next_states.step_count >= params.max_steps
        if self.log_metrics:
            self._emit_metrics(beam, rewards, next_states.step_count)
        return self._observe(magnets, beam, params.target), next_states, rewards, dones

    def batched_reset(
        self, generator: torch.Generator, params: EnvParams
    ) -> Tuple[Tensor, EnvState]:
        """:meth:`reset` for the batch of ``params`` (leading ``(B,)``):
        settings uniform in [-0.5, 0.5), drawn from ``generator``."""
        B = params.target.shape[0]
        magnets = self._uniform_magnets((B, self.num_actions), generator)
        states = EnvState(
            magnets, torch.zeros((B,), dtype=torch.int32, device=self.device), generator
        )
        beam = self.batched_beam_parameters(magnets, params)
        return self._observe(magnets, beam, params.target), states

    # -- env API -----------------------------------------------------------
    def _uniform_magnets(self, shape, generator: torch.Generator) -> Tensor:
        u = torch.rand(shape, generator=generator, dtype=self.dtype, device=generator.device)
        return (u - 0.5).to(self.device)

    def observation(self, state: EnvState, params: EnvParams) -> Tensor:
        beam = self.beam_parameters(state.magnets, params)
        return self._observe(state.magnets, beam, params.target)

    def reset(self, generator: torch.Generator, params: EnvParams) -> Tuple[Tensor, EnvState]:
        magnets = self._uniform_magnets((self.num_actions,), generator)
        state = EnvState(
            magnets, torch.zeros((), dtype=torch.int32, device=self.device), generator
        )
        return self.observation(state, params), state

    def step(
        self, state: EnvState, action: Tensor, params: EnvParams
    ) -> Tuple[Tensor, EnvState, Tensor, Tensor]:
        """Apply a (clipped) absolute magnet setting; return (obs,
        next_state, reward, done)."""
        magnets = torch.clamp(action, -1.0, 1.0)
        next_state = EnvState(magnets, state.step_count + 1, state.generator)
        beam = self.beam_parameters(magnets, params)
        reward = -torch.sum(torch.abs(beam - params.target)) * 1e3
        done = next_state.step_count >= params.max_steps
        if self.log_metrics:
            self._emit_metrics(beam, reward, next_state.step_count)
        return self._observe(magnets, beam, params.target), next_state, reward, done


def make_env(
    log_metrics: bool = False, dtype: torch.dtype = torch.float32, device=None
) -> AresEATransverseTuning:
    """The ARES-EA environment, on the card unless ``device`` says otherwise."""
    return AresEATransverseTuning(log_metrics=log_metrics, dtype=dtype, device=device)



def _gym_env_class(gymnasium):
    """The Gymnasium adapter, defined on first access (module
    ``__getattr__``), so that importing the environment needs no
    gymnasium."""

    class AresEAGymEnv(gymnasium.Env):
        """Gymnasium adapter around the functional environment, one instance.

        :param params: the instance's ``EnvParams`` (``default_params()``
            on ``device`` if None).
        :param seed: seeds the ``torch.Generator`` the resets draw from.
        :param dtype, device: of the environment; the card unless given.

        Observations are numpy arrays, rewards ``float``; each step reads
        the reward on the host, one device sync, as the Gym API needs.
        The step and the reset run through ``graphs.graphed(env.step)`` and
        ``graphs.graphed(env.reset)``, as the JAX adapter's run through
        ``jax.jit``: on the card one graph each, captured at the first call
        and replayed after.  The reset draws from the adapter's
        ``torch.Generator``, which ``graphed`` registers with its graph, so
        a replay draws what an eager reset would, ``reset(seed=...)``'s
        re-seeding included.  A torch that cannot register a generator with
        a graph resets eagerly.
        """

        metadata = {"render_modes": []}

        def __init__(
            self,
            params: Optional[EnvParams] = None,
            seed: int = 0,
            dtype: torch.dtype = torch.float32,
            device=None,
        ):
            self._env = make_env(dtype=dtype, device=device)
            device = self._env.device
            self._params = (
                params if params is not None else default_params(dtype=dtype, device=device)
            )
            self._generator = torch.Generator(device=device).manual_seed(seed)
            self._state = None
            self._step = graphed(self._env.step)
            registers = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
            self._reset = graphed(self._env.reset) if registers else self._env.reset
            self.action_space = gymnasium.spaces.Box(
                low=-1.0, high=1.0, shape=(self._env.num_actions,)
            )
            self.observation_space = gymnasium.spaces.Box(
                low=-np.inf,
                high=np.inf,
                shape=(self._env.obs_size,),
                dtype=torch.empty((), dtype=dtype).numpy().dtype,
            )

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            if seed is not None:
                self._generator.manual_seed(seed)
            obs, self._state = self._reset(self._generator, self._params)
            return obs.cpu().numpy(), {}

        def step(self, action):
            action = torch.as_tensor(
                np.asarray(action), dtype=self._env.dtype, device=self._env.device
            )
            obs, self._state, reward, done = self._step(self._state, action, self._params)
            return obs.cpu().numpy(), float(reward), bool(done), False, {}

    return AresEAGymEnv


def __getattr__(name: str):
    """``AresEAGymEnv`` exists only where gymnasium imports (an optional
    dependency); it is built on first access."""
    if name == "AresEAGymEnv":
        try:
            import gymnasium
        except ImportError:
            raise AttributeError(f"{name} needs gymnasium, which does not import") from None
        cls = globals()[name] = _gym_env_class(gymnasium)
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
