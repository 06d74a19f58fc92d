"""The port's examples (``lynx_tpu_torch.examples``) at small sizes on the
CPU, held to the JAX package's examples (``examples/``) where their
results are deterministic: the tuned magnets of ``gradient_tuning`` (the
same task, both in float64), the fitted emittance of
``emittance_measurement`` and the recovered strengths of ``image_tuning``,
each against what the JAX example prints (to its printed digits, or to the
divergence that the start at k1 = 0 allows: d/dk1 there is
rounding-limited in both packages, ``ROADMAP.md`` §C).  The random beams of
the other examples differ between the packages; those are checked for what
they must show.
"""

import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu.envs
import lynx_tpu.ops.pallas_track as jax_pallas_track
import lynx_tpu_torch as ltt
from lynx_tpu.accelerator import fused as jax_fused
from lynx_tpu.envs import ares_ea as jax_env_module
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.envs import ares_ea as torch_env_module
from lynx_tpu_torch.examples import (
    emittance_measurement,
    gradient_tuning,
    image_tuning,
    particle_fidelity_sweep,
    ppo_ares_ea,
    simple,
)
from lynx_tpu_torch.ops import fused_track

REPO = Path(__file__).resolve().parent.parent
NUMBER = r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?"


def run_jax_example(name, capsys, *args):
    """Run ``examples/<name>.py``'s ``main(*args)``; return what it prints."""
    capsys.readouterr()
    runpy.run_path(str(REPO / "examples" / f"{name}.py"))["main"](*args)
    return capsys.readouterr().out


def numbers(text, label):
    """The numbers on the printed line that starts with ``label``."""
    line = next(line for line in text.splitlines() if line.startswith(label))
    return [float(x) for x in re.findall(NUMBER, line[len(label):])]


@pytest.fixture
def float64_jax_env(monkeypatch):
    """JAX's env in float64: its lattice and the beams it builds."""
    original = lt.ParameterBeam.from_parameters.__func__
    monkeypatch.setattr(
        lt.ParameterBeam, "from_parameters",
        classmethod(lambda cls, *a, **k: original(cls, *a, **{"dtype": jnp.float64, **k})),
    )

    def make_env(*args, **kwargs):
        env = jax_env_module.make_env(*args, **kwargs)
        env._segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), env._segment)
        return env

    monkeypatch.setattr(lynx_tpu.envs, "make_env", make_env)


def test_gradient_tuning_matches_jax(float64_jax_env, capsys):
    """Both runs start at k1 = 0, where the two packages' gradients differ
    by ~2e-6 relative (rounding-limited); after 25 Adam steps the settings
    and losses agree to 1e-4."""
    steps = 25
    printed = run_jax_example("gradient_tuning", capsys, steps)
    jax_params = jax_env_module.default_params(jax.random.PRNGKey(42))
    params = torch_env_module.EnvParams(
        *(torch.tensor(np.asarray(x)) for x in jax_params[:3]))
    settings, losses, observed = gradient_tuning.main(steps, device="cpu", dtype=torch.float64,
                                                      params=params)
    assert losses.shape == (steps,) and float(losses[-1]) < float(losses[0])
    physical = (settings * torch.from_numpy(torch_env_module.MAGNET_LIMITS).double()).numpy()
    np.testing.assert_allclose(physical[:3], numbers(printed, "tuned k1 [1/m^2]:"), rtol=1e-4)
    np.testing.assert_allclose(physical[3:], numbers(printed, "tuned angles [rad]:"), rtol=1e-4)
    np.testing.assert_allclose(
        float(losses[-1]), numbers(printed, f"step {steps - 1:4d}  |beam - target| =")[0],
        rtol=1e-4)
    np.testing.assert_allclose(observed.numpy() * 1e3, numbers(printed, "achieved beam [mm]:"),
                               rtol=1e-4)


def test_emittance_measurement_matches_jax(capsys):
    printed = run_jax_example("emittance_measurement", capsys)
    result = emittance_measurement.main(device="cpu", dtype=torch.float64)
    assert abs(result["emittance"] / result["true_emittance"] - 1) < 0.01
    np.testing.assert_allclose(result["emittance"], numbers(printed, "fitted emittance_x:")[0],
                               rtol=1e-4)
    s11, s12, s22 = numbers(printed, "fitted sigma_11=")[0::2]
    np.testing.assert_allclose(result["sigma"], (s11, s12, s22), rtol=1e-3)
    np.testing.assert_allclose(result["true_emittance"], 2.2e-9, rtol=1e-12)


def test_image_tuning_matches_jax(capsys):
    printed = run_jax_example("image_tuning", capsys)
    params, losses = image_tuning.main(device="cpu", dtype=torch.float64)
    assert float(losses[-1]) < 1e-3 * float(losses[0])
    np.testing.assert_allclose(params.numpy(), numbers(printed, "recovered k =")[:2], atol=2e-3)
    np.testing.assert_allclose(params.numpy(), image_tuning.TRUE_K, atol=1e-2)


@pytest.mark.parametrize("B", [8, 20])
def test_particle_fidelity_sweep(B, monkeypatch):
    """Route 1's moments equal the dense push; route 2 on the CPU's plain
    walk equals the kernel route's plain versions (B5's below 16 settings,
    B6's from 16)."""
    result = particle_fidelity_sweep.main(B, 3000, device="cpu")
    assert result["drift"] < 1e-4
    mu, cov, survivors = result["moments"]
    assert mu.shape == (B, 7) and cov.shape == (B, 7, 7)
    assert bool(((survivors > 0) & (survivors < 3000)).all())
    monkeypatch.setattr(fused_track, "PARTICLE_MOMENT_SWEEP_PATH", True)
    kernel_mu, kernel_cov, kernel_w = fused_track.sweep_particle_moments(*result["plan"])
    assert torch.equal(kernel_w, survivors)
    torch.testing.assert_close(kernel_mu, mu, rtol=1e-5, atol=1e-5 * float(mu.abs().max()))
    torch.testing.assert_close(kernel_cov, cov, rtol=1e-4, atol=1e-4 * float(cov.abs().max()))


def test_particle_fidelity_sweep_route_2_matches_jax():
    """Route 2 of the example on the example's own particles and aperture
    lattice, in float64, against JAX's ``particle_moment_plan`` and
    ``sweep_particle_moments`` on the same particles: the same survivors,
    and the moments within 1e-10 relative to each setting's largest
    (second moments of a centred cloud: ``mu`` relative to ``sqrt(cov)``)."""
    B, N = 8, 3000
    result = particle_fidelity_sweep.main(B, N, device="cpu")
    particles = result["beam"].particles[0].double()
    energy = result["beam"].energy.double()
    f64 = jnp.float64
    jax_elements = [
        lt.Drift(jnp.array([0.3], f64), dtype=f64),
        lt.Quadrupole(jnp.array([0.12], f64), k1=jnp.linspace(-8.0, 8.0, B, dtype=f64),
                      dtype=f64),
        lt.Aperture(x_max=jnp.array([3e-4], f64), y_max=jnp.array([4e-4], f64),
                    is_active=True, dtype=f64),
        lt.Drift(jnp.array([0.4], f64), dtype=f64),
    ]
    entries, scalars = jax_fused.particle_moment_plan(
        jax_elements, jnp.asarray(energy.numpy()),
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    jax_mu, jax_cov, jax_w = (np.asarray(x) for x in jax_pallas_track.sweep_particle_moments(
        entries, scalars, jnp.asarray(particles.numpy()), jnp.ones((N,), f64)))

    entries, scalars = torch_fused.particle_moment_plan(
        particle_fidelity_sweep.aperture_lattice(B, dtype=torch.float64, device="cpu"), energy,
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )
    mu, cov, w = (x.numpy() for x in fused_track.sweep_particle_moments(
        entries, scalars, particles, torch.ones((N,), dtype=torch.float64)))

    np.testing.assert_array_equal(w, jax_w)
    assert ((w > 0) & (w < N)).all()
    # The float32 run of the example keeps the same particles.
    np.testing.assert_array_equal(result["moments"][2].numpy(), w)
    scale = np.abs(jax_cov).max(axis=(1, 2))
    np.testing.assert_array_less(np.abs(cov - jax_cov).max(axis=(1, 2)), 1e-10 * scale)
    np.testing.assert_array_less(np.abs(mu - jax_mu).max(axis=1), 1e-10 * np.sqrt(scale))


#: Each example's ``main`` at a tiny size, with ``**kw`` its device argument.
EXAMPLE_MAINS = {
    "simple": (simple, lambda **kw: simple.main(num_particles=500, **kw)),
    "gradient_tuning": (gradient_tuning, lambda **kw: gradient_tuning.main(steps=2, **kw)),
    "emittance_measurement": (
        emittance_measurement, lambda **kw: emittance_measurement.main(steps=2, **kw)),
    "image_tuning": (image_tuning, lambda **kw: image_tuning.main(steps=2, **kw)),
    "particle_fidelity_sweep": (
        particle_fidelity_sweep, lambda **kw: particle_fidelity_sweep.main(8, 500, **kw)),
    "ppo_ares_ea": (ppo_ares_ea, lambda **kw: ppo_ares_ea.main(1, 4, 2, **kw)),
}


def run_example(name, **kw):
    """``EXAMPLE_MAINS[name]``'s result; image_tuning's two steps end in
    its own check that the loss collapsed, which is what it returns here."""
    if name == "image_tuning":
        with pytest.raises(AssertionError, match="image loss did not collapse"):
            EXAMPLE_MAINS[name][1](**kw)
        return ()
    return EXAMPLE_MAINS[name][1](**kw)


def tensors(value):
    """Every tensor in an example's result (tuples, lists, dicts, beams)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    elif isinstance(value, ltt.ParticleBeam):
        value = [value.particles, value.energy, value.particle_charges]
    if isinstance(value, (tuple, list)):
        return [t for item in value for t in tensors(item)]
    return []


@pytest.mark.parametrize("name", sorted(EXAMPLE_MAINS))
def test_example_without_a_device_builds_where_the_resolver_says(name, monkeypatch):
    """``main()`` without ``device=`` resolves it once, at its start, through
    ``resolve_device`` (whose default is ``cuda``) and builds everything
    there: with the example's own resolver mapping the default to the CPU,
    and every other module's left as it is, the run ends on the CPU.  A
    tensor built without the resolved device, or a builder handed
    ``device=None``, would ask for the card and raise here."""
    module, _ = EXAMPLE_MAINS[name]
    asked = []

    def to_cpu(device=None, *values):
        asked.append(device)
        return torch.device("cpu") if device is None else torch.device(device)

    monkeypatch.setattr(module, "resolve_device", to_cpu)
    result = run_example(name)
    assert asked[0] is None and None not in asked[1:]
    assert {t.device for t in tensors(result)} <= {torch.device("cpu")}


@pytest.mark.parametrize("name", sorted(EXAMPLE_MAINS))
def test_example_without_a_device_needs_the_card(name):
    """No silent CPU fallback: without CUDA, ``main()`` raises torch's own
    error; with it, the result lives on the card."""
    if torch.cuda.is_available():
        assert {t.device.type for t in tensors(run_example(name))} <= {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            EXAMPLE_MAINS[name][1]()


def test_simple_bpm_follows_the_kick():
    sigma_x, reading, kicked = simple.main(num_particles=2000, device="cpu")
    assert 1e-4 < sigma_x < 3e-4
    # H10SMATCH's 0.2 mrad kick, 7.35 m upstream of the BPM (plus half the
    # corrector), moves x by ~1.5 mm and leaves y.
    assert 1.4e-3 < float(kicked[0] - reading[0]) < 1.6e-3
    assert float(kicked[1]) == float(reading[1])


def test_ppo_main_trains_on_the_cpu():
    history = ppo_ares_ea.main(updates=2, num_envs=8, rollout=3, device="cpu")
    assert len(history) == 2 and np.isfinite(history).all()


def test_examples_run_as_modules():
    result = subprocess.run(
        [sys.executable, "-m", "lynx_tpu_torch.examples.simple", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    assert "BPM13 after kick" in result.stdout
