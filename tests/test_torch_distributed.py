"""The port's multi-node start-up on four Gloo ranks standing for two nodes
of two ranks (``LOCAL_WORLD_SIZE`` 2): ``tests/test_distributed.py``'s
contract.

Each rank joins through ``parallel.initialize``, builds the global (batch
= nodes, particles = local ranks) mesh, assembles a ParameterBeam from its
node's slice of the settings (``host_local_beam_to_global``), replicates
the segment (``replicate_to_global``) and runs five Adam steps of
``make_tuning_train_step`` on every field of the segment, as JAX's optax
tunes every leaf.  The ranks agree to 1e-12; they match the single-process
port and JAX's single-process loop, both in float64, to 1e-8 (JAX's own
bound between its distributed and single-process runs).  The fixture
kills every rank if one hangs.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lynx_tpu as lt
import lynx_tpu_torch as ltt
import torch_parallel_worker as w
from lynx_tpu.functional import track as jax_track
from lynx_tpu_torch import functional, parallel

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.run_ranks("distributed", tmp_path_factory.mktemp("distributed"))


def torch_single_process():
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor(w.SIGMA_X_GLOBAL), sigma_y=torch.full((w.DIST_BATCH,), 2e-4),
        energy=torch.full((w.DIST_BATCH,), 1.073e8), dtype=torch.float64, device="cpu",
    )
    segment = w.dist_segment(ltt, torch)
    params = [b.requires_grad_(True) for b in segment.buffers() if b.is_floating_point()]
    optimizer = torch.optim.Adam(params, lr=1e-1)

    def loss_fn(seg, b):
        out, _ = functional.track(seg, b)
        return torch.mean((out.sigma_x - 5e-5) ** 2) * 1e8

    step = parallel.make_tuning_train_step(optimizer, loss_fn)
    for _ in range(w.DIST_STEPS):
        segment, loss = step(segment, beam)
    return float(loss), float(segment.elements[1].k1.reshape(()))


def jax_single_process():
    """``tests/test_distributed.py``'s single-process loop, in float64."""
    f64 = dict(dtype=jnp.float64)
    beam = lt.ParameterBeam.from_parameters(
        sigma_x=jnp.asarray(w.SIGMA_X_GLOBAL), sigma_y=jnp.full((w.DIST_BATCH,), 2e-4),
        energy=jnp.full((w.DIST_BATCH,), 1.073e8), **f64,
    )
    segment = lt.Segment([
        lt.Drift(length=jnp.asarray(0.5), **f64),
        lt.Quadrupole(length=jnp.asarray(0.2), k1=jnp.asarray(4.0), **f64),
        lt.Drift(length=jnp.asarray(0.5), **f64),
    ])
    optimizer = optax.adam(1e-1)
    opt_state = optimizer.init(segment)

    def loss_fn(seg, b):
        out, _ = jax_track(seg, b)
        return jnp.mean((out.sigma_x - 5e-5) ** 2) * 1e8

    @jax.jit
    def step(seg, opt_state, b):
        loss, grads = jax.value_and_grad(loss_fn)(seg, b)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(seg, updates), opt_state, loss

    for _ in range(w.DIST_STEPS):
        segment, opt_state, loss = step(segment, opt_state, beam)
    return float(loss), float(jnp.reshape(segment.elements[1].k1, ()))


def test_global_mesh_spans_nodes_and_local_ranks(ranks):
    for rank, r in enumerate(ranks):
        assert r["distributed/shape"].tolist() == [2, w.LOCAL_WORLD_SIZE]
        assert int(r["distributed/count"]) == 4 and int(r["distributed/index"]) == rank


def test_processes_agree(ranks):
    for r in ranks[1:]:
        for key in ("loss", "k1"):
            np.testing.assert_allclose(r[f"distributed/{key}"], ranks[0][f"distributed/{key}"],
                                       rtol=1e-12)


@pytest.mark.parametrize("reference", [torch_single_process, jax_single_process])
def test_matches_single_process(ranks, reference):
    loss, k1 = reference()
    np.testing.assert_allclose(float(ranks[0]["distributed/loss"]), loss, rtol=1e-8)
    np.testing.assert_allclose(float(ranks[0]["distributed/k1"]), k1, rtol=1e-8)
    assert k1 != 4.0


def test_single_process_defaults_without_a_process_group():
    """Without a process group the counts are those of one process, and a
    mesh asks for `initialize` (the ranks call it twice: it is idempotent)."""
    assert not parallel.is_initialized()
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    with pytest.raises(RuntimeError, match="initialize"):
        parallel.make_mesh(1, device_type="cpu")


def test_multichip_tuning_example_on_four_ranks(ranks):
    """``examples/multichip_tuning`` in the four-rank world: a (2, 2) mesh,
    8 settings of 4,096 particles; the train-step loop and the tuner take
    the same steps from the same start, and the loss falls."""
    for r in ranks:
        assert r["example/mesh"].tolist() == [2, 2]
        np.testing.assert_allclose(r["example/tuner"], r["example/losses"], rtol=1e-12)
        np.testing.assert_allclose(r["example/losses"], ranks[0]["example/losses"], rtol=1e-12)
        assert r["example/losses"][-1] < r["example/losses"][0]


def test_multichip_tuning_example_alone():
    """Run alone the example is a one-rank world, a 1 x 1 mesh."""
    result = subprocess.run(
        [sys.executable, "-m", "lynx_tpu_torch.examples.multichip_tuning", "--steps", "3",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    lines = result.stdout.splitlines()
    assert lines[0] == "mesh {'batch': 1, 'particles': 1}, batch=4, particles=2048"
    first = float(lines[1].split()[-1])
    assert lines[-1].startswith(f"tuner (3 steps): loss {first:.3e} -> ")
