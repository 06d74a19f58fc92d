"""The particle moment plan's runs folded per setting (kernel B10,
``ops/fused_track.map_fold``) on the CPU: the plan's bookkeeping around it
(layout, offsets, row views), with its plain version forced by patching
``accelerator/fused._fold_batch``, against the table algebra (the plan's
route on the CPU and the tests' oracle), the route's choices and the
counters.  B10's own arithmetic is held to its plain version by the host
build (``tests/test_torch_kernels_host.py``) and, marked ``card``, on the
card: eagerly and replayed from a CUDA graph, with its routing under
gradients.  This file imports no JAX: on the
card run it alone, without the suite's conftest,

    python3 -m pytest tests/test_torch_map_fold.py --noconftest -m card -q

Lattices: the ARES-EA segment, one of every element kind the full
instantiation builds (``test_torch_particle_push.full_kinds``: a tilted
dipole with edges and fringe fields, a thin one, an RBend, a misaligned
solenoid, an inactive cavity, an undulator, a custom map) beside misaligned
quadrupoles with k1 = 0 on a setting, correctors and the identity elements,
path V's random element mixes of seeds 0-15 (``chip_smoke.random_lattice``,
every field per setting, the cavities inactive so that each lattice plans),
and the particle-fidelity example's aperture lattice, whose aperture splits
the plan into two runs.  Bounds (``chip_smoke.fold_error``: per setting and
row of each composed map, relative to the row's largest cell): float64
within path V's 1e-12 (``chip_smoke.DOUBLE_RTOL``), float32 within B2's
1e-5 (``chip_smoke.FLOAT_RTOL``).
"""

import contextlib

import pytest
import torch

import chip_smoke
import lynx_tpu_torch as ltt
from lynx_tpu_torch import envs, graphs
from lynx_tpu_torch.accelerator import fused
from lynx_tpu_torch.examples.particle_fidelity_sweep import aperture_lattice
from lynx_tpu_torch.ops import fused_track as ft
from tests.test_torch_particle_push import ares, full_kinds

B = 3
ENERGY = 1.073e8
RTOL = {torch.float64: chip_smoke.DOUBLE_RTOL, torch.float32: chip_smoke.FLOAT_RTOL["B2"]}
LATTICES = ("ares_ea", "full_kinds", *(f"random_{seed}" for seed in chip_smoke.RANDOM_SEEDS),
            "aperture")
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])


@pytest.fixture
def folds(monkeypatch):
    """Count the plain B10's calls."""
    calls = []
    original = ft.map_fold_reference
    monkeypatch.setattr(ft, "map_fold_reference",
                        lambda *args: calls.append(args[-1].shape) or original(*args))
    return calls


def elements(name, dtype, batch=B):
    if name == "ares_ea":
        return ares(batch, dtype).flattened().elements
    if name == "full_kinds":
        return full_kinds(batch, dtype).flattened().elements
    if name == "aperture":
        return aperture_lattice(batch, dtype=dtype, device="cpu")
    seed = int(name.split("_")[1])
    segment = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        dtype=dtype, device="cpu")
    settings = chip_smoke.random_settings(torch, segment, batch, seed, cavities=False)
    chip_smoke.apply_settings(segment, settings)
    return segment.flattened().elements


def vec(x, batch=B):
    return torch.broadcast_to(torch.as_tensor(x).reshape(-1), (batch,))


@contextlib.contextmanager
def folding():
    """B10's route for every run, whatever the device: on the CPU,
    ``map_fold`` runs its plain version."""
    original = fused._fold_batch
    fused._fold_batch = lambda values, energy: torch.broadcast_shapes(
        energy.shape, *(v.shape for v in values))[0]
    try:
        yield
    finally:
        fused._fold_batch = original


def plan(els, dtype, fold, energy=None):
    """The plan, through B10's route where ``fold`` else by device and
    gradient, with the runs it counted: ``((entries, scalars), folded,
    table)``."""
    counts = fused.particle_moment_plan.folded_runs, fused.particle_moment_plan.table_runs
    energy = torch.tensor(ENERGY, dtype=dtype) if energy is None else energy
    with folding() if fold else contextlib.nullcontext():
        result = fused.particle_moment_plan(els, energy, vec)
    return (result, fused.particle_moment_plan.folded_runs - counts[0],
            fused.particle_moment_plan.table_runs - counts[1])


def worst_error(result, expected):
    entries, scalars = result
    assert entries == expected[0]
    return max((chip_smoke.fold_error(torch, e[1], scalars, expected[1])
                for e in entries if e[0] == "map"), default=0.0)


@DTYPES
@pytest.mark.parametrize("name", LATTICES)
def test_plain_fold_gives_the_table_route(name, dtype, folds):
    """Forced on the CPU, B10's plain version gives the table route's
    entries exactly and its scalars within the bounds, each scalar a row of
    one ``(n_cells, B)`` output; each route counts its runs."""
    els = elements(name, dtype)
    table, folded, tabled = plan(els, dtype, False)
    maps = sum(entry[0] == "map" for entry in table[0])
    assert (folded, tabled) == (0, maps) and not folds
    result, folded, tabled = plan(els, dtype, True)
    assert (folded, tabled) == (maps, 0) and len(folds) == maps
    assert maps == (2 if name == "aperture" else 1)
    assert worst_error(result, table) <= RTOL[dtype]
    for entry in result[0]:
        if entry[0] == "map":
            rows = [result[1][c] for row in entry[1] for c in row if not isinstance(c, float)]
            assert all(r.shape == (B,) and r.dtype == dtype for r in rows)
            assert len({r.untyped_storage().data_ptr() for r in rows}) == 1


@DTYPES
def test_fold_keeps_the_identity_drop(dtype, folds):
    """A run of identity elements composes to nothing on both routes; the
    apertures' scalars are the table route's."""
    kw = dict(dtype=dtype, device="cpu")
    els = [ltt.Marker(**kw), ltt.BPM(**kw),
           ltt.Aperture(x_max=torch.tensor([1e-3], **kw), y_max=torch.tensor([2e-3], **kw),
                        is_active=True, **kw),
           ltt.Screen(**kw)]
    table, _, tabled = plan(els, dtype, False)
    result, folded, _ = plan(els, dtype, True)
    assert (tabled, folded) == (0, 0) and not folds
    assert result[0] == table[0] == (("aperture", 0, 1, "rectangular"),)
    assert all(torch.equal(a, b) for a, b in zip(result[1], table[1]))


ROUTING_CASES = ["no grad", "grad on a field", "grad on the energy", "no grad mode"]


def routing_inputs(case, device):
    """The ARES-EA segment's elements and energy on ``device`` for a routing
    case, and the leaf that needs a gradient (None if none does)."""
    dtype = torch.float64
    els = ares(B, dtype).to(device).flattened().elements
    energy = torch.tensor(ENERGY, dtype=dtype, device=device)
    quadrupole = next(el for el in els if type(el) is ltt.Quadrupole)
    leaf = None
    if case in ("grad on a field", "no grad mode"):
        leaf = quadrupole.k1 = quadrupole.k1.clone().requires_grad_(True)
    if case == "grad on the energy":
        leaf = energy = energy.clone().requires_grad_(True)
    return els, energy, leaf


def check_routing(case, device):
    """The plan of ``routing_inputs``: B10's route on the card where nothing
    needs a gradient (grad mode off included), else the table algebra, whose
    gradient reaches the leaf; returns the runs each route took."""
    els, energy, leaf = routing_inputs(case, device)
    with torch.no_grad() if case == "no grad mode" else contextlib.nullcontext():
        result, folded, tabled = plan(els, torch.float64, False, energy)
    folds = device == "cuda" and case in ("no grad", "no grad mode")
    assert (folded, tabled) == ((1, 0) if folds else (0, 1))
    if leaf is not None and case != "no grad mode":
        (grad,) = torch.autograd.grad(sum(s.sum() for s in result[1]), leaf)
        assert bool(torch.isfinite(grad).all()) and bool((grad != 0).any())


@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing(case, folds):
    """On the CPU every run takes the table algebra, with or without a
    gradient, and B10's plain version is never called."""
    check_routing(case, "cpu")
    assert not folds


def test_the_wrapper_refuses_a_gradient():
    """B10 has no backward: its launch refuses an input that needs one."""
    els = elements("ares_ea", torch.float64)
    builders = [fused.element_map_builder(el) for el in els]
    run = tuple(("dyn", fn, len(values)) for values, fn in builders)
    values = [vec(p).clone().requires_grad_(True) for values, _ in builders for p in values]
    with pytest.raises(ValueError, match="no backward"):
        ft._map_fold_cuda(run, values, torch.full((B,), ENERGY, dtype=torch.float64))


@DTYPES
def test_env_observation_through_the_fold(dtype, folds):
    """The ARES-EA env's particle observation (``method="kernel"``, one
    shared cloud) takes B10's plain version once a step where forced, with
    the table route's observation, and reads nothing on the host (the CPU
    rehearsal of its capture)."""
    cloud = chip_smoke.random_particle_beam(torch, ltt, 1, 200, 5, "cpu", dtype=dtype)
    beam = ltt.ParticleBeam(cloud.particles[0], cloud.energy[0])
    env = envs.make_env(dtype=dtype, device="cpu", beam=beam, method="kernel")
    magnets = torch.rand((7, 5), generator=torch.Generator().manual_seed(3), dtype=dtype) - 0.5
    table = env.batched_particle_beam_parameters(magnets, beam, method="kernel")
    with folding():
        env.batched_particle_beam_parameters(magnets, beam, method="kernel")  # the tape, cached
        with graphs.host_read_guard():
            folded = env.batched_particle_beam_parameters(magnets, beam, method="kernel")
    assert folds == [(7,), (7,)]
    scale = table.abs().amax(dim=0)
    assert float(((folded - table).abs() / scale).max()) <= RTOL[dtype]


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@DTYPES
@pytest.mark.parametrize("batch", chip_smoke.MAP_FOLD_BATCHES)
def test_b10_against_its_plain_version_on_the_card(card, batch, dtype):
    """B10 (the route for CUDA fields) against its plain version on the same
    CUDA operands and against the table algebra, eagerly and replayed from a
    CUDA graph on new fields; one launch a run."""
    plans = chip_smoke.fold_plans(torch, ltt, envs, batch, dtype, seed=batch)
    for label in ("ares_ea", "aperture"):
        make_elements, energy, field = plans[label]
        routes, launched = chip_smoke.fold_routes(torch, ft, fused, make_elements(), energy,
                                                  batch)
        assert launched == sum(e[0] == "map" for e in routes["B10"][0])
        for against in ("plain", "table"):
            assert chip_smoke.plan_errors(torch, routes, against) <= RTOL[dtype], label

        def run():
            return fused.particle_moment_plan(make_elements(), energy,
                                              lambda x: vec(x, batch))

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graphs.capture_scope(), torch.cuda.graph(graph):
            replayed = run()
        field.copy_(field.flip(0) * 0.9)
        graph.replay()
        torch.cuda.synchronize()
        routes, _ = chip_smoke.fold_routes(torch, ft, fused, make_elements(), energy, batch)
        routes["replayed"] = replayed
        for against in ("B10", "plain"):
            assert chip_smoke.plan_errors(torch, routes, against, of="replayed") <= RTOL[dtype]


@pytest.mark.card
@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_on_the_card(card, case):
    """On the card a run takes B10 unless an input needs a gradient; then
    the table algebra, whose gradient reaches the leaf."""
    launched = ft.map_fold.launches
    check_routing(case, "cuda")
    assert ft.map_fold.launches - launched == int(case in ("no grad", "no grad mode"))
