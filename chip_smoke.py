#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lynx_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. require a CUDA device, pin TF32 off (and say so), print the card and its
   power limit;
2. build kernels B1-B7 (``lynx_tpu_torch/csrc/*.cu``), one nvcc each, all
   started together, and print each build's seconds and, for each kernel
   and instantiation, its ptxas registers and spill-store/spill-load bytes;
3. hold B1's (lx, ly) count core against its plain PyTorch version on the
   card at the flagship shapes and at the edge cases (count mode exactly
   equal, weighted mode within 1e-5 relative of the plain version in
   float64); hold B1's read (``windowed_read``: two passes and the
   completion) against its plain versions (``windowed_read_reference``,
   ``complete_read_reference``) on the same CUDA tensors at the flagship's
   B = 1 and 8, on path L's window, bin edges, NaN and +-inf with an
   all-dead row, a spot past its window, Python-float ranges and N =
   100,003 (the image exact in count mode, within 1e-5 relative weighted,
   origins and fits equal), and print B7 twolevel's
   ``cudaOccupancyMaxActiveClusters``; hold B2-B6
   against theirs at the main paths' shapes and at the edge cases, in
   double and in float (bounds below; B5 and B6 on a ragged B and N =
   100,003, rectangular and elliptical apertures, two in one plan, x_max =
   inf, a setting that loses every particle, no aperture, and an
   identity-only plan with ``batch_size=``; B5 also at B = 1 and 15, the
   route's edges, on 300 particles, fewer than one block's span, and on
   none; B3 and B4 also on one batched
   element of each kind of the full lattice and on the full lattice's
   plan); fault C1: B4 on ``fodo_lattice(150)``'s 901 entries at 16,384
   settings in double, past the prefix products that fit in shared memory;
4. drive the flagship path, the ARES EA track of a 100k-particle beam and
   the 2448 x 2040 read of screen AREABSCR1, at B = 1 (``functional.track``
   and ``Segment.track`` + ``reading``) and B = 8; check the images, that
   B1 served every read (three launches a read) and that no
   read fell back, and hold the images against the port's CPU path on the
   same particles;
5. time the flagship track + read with CUDA events; the windowed read's
   device time (all of its GPU work) through the fused read and through
   the composed read (the prologue in PyTorch, B1's count core,
   ``_place``) in turns, beside the full-image scatter, B1's kernels' own time, its bound
   and the read's floor (the image written once), and the device kernels a
   read issues (at most 4: the zeroing and B1's three, no host sync) and a
   flagship call issues;
6. path S, serving: the ARES-EA environment's ``batched_reset`` and 10
   ``batched_step``s at B = 100,000 settings through B3; path T, training:
   ``tuning.tune`` of (100,000, 5) settings for 10 Adam steps through B3
   and B4; path P, the particle push: ``Segment.track`` of 100 settings x
   10,000 particles through B2 and its gradient.  Each path runs with the
   launch counts set to 0 just before it, reads them just after, and checks
   that no plain version ran on a CUDA tensor;
7. path K, the env's particle-fidelity observation ``method="kernel"``
   with one shared 100,000-particle cloud at B = 256 (B6) and 8 (B5), held
   against ``method="moments"``, and env-steps/s of the three methods; path
   A, the aperture-interleaved sweep (``benchmarks/aperture_sweep_ab.py``'s
   lattice) at B = 32 and 256 through B6 with the gradient of sum(sigma_x)
   with respect to k1, held against dense ``functional.track`` and against
   autograd of the plain walk in double; the B5/B6 crossover at B = 8, 16,
   32, 64, 128 and 256 and the B where B6's route becomes faster; B5's and
   B6's times against their plain versions and B5's parent's.  In the
   forward no plain version runs on a CUDA tensor; the backward is autograd
   of the plain walk, the JAX package's design, and is counted apart;
8. path L, the full ARES lattice (195 elements): the read of AREABSCR1
   by a 100k-particle beam from the lattice's start through B1, held
   against the CPU path's image,
   and its read timed as the flagship's; a ParameterBeam sweep at 100,000 settings
   (every quadrupole, corrector, solenoid and dipole per setting) through B3
   and its gradient through B4, held against the dense route in double;
   kernel B7, the count-histogram A/B (``lynx_tpu_torch.benchmarks.hist_ab``):
   every variant (onehot's chunks; twolevel's clusters of C = 8 and 16
   blocks, K = 1-8 clusters) exactly against its plain version and B1's
   count mode (a spot, pads and pairs past the window, all padded, 33 pairs,
   and every pair in one 16-row tile, one bucket of the onehot read), then the
   harness with its yardsticks (B1, ``torch.bincount``), each read's device
   time summed over its kernels beside its main kernel's;
9. path I, the beam and lattice I/O slice: I1, the ASTRA beam
   (``ParticleBeam.from_astra``, 100,000 particles at 107.3 MeV) on the
   flagship screen of ``ares_lattice()`` written as LatticeJSON and read
   back, read through B1 as loaded and ``transformed_to`` a moved spot,
   each image equal to the original lattice's, and its Twiss values at
   AREABSCR1's plane held to ``ParameterBeam.from_astra``'s; I2a, the same
   beam through the NX-tables ARES lattice's 45 elements to ARMRBSCR1, read
   through B1; I2b, a ParameterBeam with the ASTRA beam's Twiss values
   through the whole NX-tables lattice (235 elements) at 100,000 settings
   through B3, and the gradient of sum(beta_x + beta_y) through B4, held
   against the dense route in double;
10. path R, the RL-training and tuning slice (``lynx_tpu_torch.examples``):
    R1, PPO (``ppo_ares_ea.collect_and_update``) on the env at 100,000
    settings, rollout 16, 3 updates, every env step through B3 (16 x 3 + 1
    launches), its first update held against the same update on the CPU in
    double, the loss, mean reward and gradient each within 10 times the CPU
    path's own float-against-double spread of it, env-transitions/s, the device's busy share and B3's, the top device ops
    (``profiling.device_op_profile``), and one update at the example's 512
    envs (dense route); R2, one ``batched_step`` at 100,000 with
    ``log_metrics`` on: one line, ``step=1``, the observation's means; R3,
    the tuning examples (``gradient_tuning``, ``emittance_measurement``
    within 1% of the true emittance, ``image_tuning``); R4,
    ``particle_fidelity_sweep`` at B = 64 through B6 and B = 8 through B5,
    held against the plain walk in double; R5, ``debug.validate_beam`` on
    R1's and R4's beams and ``debug.nan_debug`` on a clean card sweep and
    on one with a NaN setting;
11. path O, the ``optimize_speed`` example (``fodo_lattice(150)``, 1058
    elements): ms per track at each of its four stages (as built; inactive
    markers removed and inactive elements as drifts; the maps merged; the
    merged lattice at B = 1000 settings, the dense route), then the merged
    lattice at B = 1000 through B3 (the fused route forced), held against
    the dense route in double, tracks/s of both;
12. path M, the parallel layer (``lynx_tpu_torch.parallel``) in a one-rank
    NCCL world on a 1 x 1 (batch, particles) mesh, at full width: the
    flagship read of the 100,000-particle beam through ``shard_beam`` under
    the particle context (B1, the image exactly the unsharded one), path
    P's 100 x 10,000 push (B2), ``make_tuning_train_step`` over the env's
    subcell at 100,000 settings for 10 Adam steps (B3, B4) against the
    unsharded tuner, the settings-sharded particle moment sweep at B = 256
    (B6), ``pipeline_track`` with one stage against ``functional.track``
    and the ``multichip_tuning`` example; for each of the first four, the
    kernels' launches equal to the unsharded call's, the NCCL kernels a call
    (profiler kernel names) and both calls' ms;
13. path V, random element mixes through B1-B6: V1, the four lattices
    of ``tests/resources/golden_tracking.npz`` in float64 through the dense
    route and tiled to 16 settings through B2, held to the file at its
    tolerances; then seeds 0-15 of ``tests/test_random_lattices.py``'s
    generator (copied here as ``random_lattice``, 8 to 24 elements) with
    every magnet's, corrector's and cavity's parameter drawn per setting:
    V2, a float64 ParameterBeam at 100,000 settings through B3 and the
    gradient of a scalar loss through B4, held against the dense route on
    the card and, on the first 1,024 settings, against the CPU's plain
    B3/B4; V3, (32, 10,000, 7) float64 ParticleBeams through B2 against
    the dense push; V4, an aperture inserted mid-lattice (cavities off)
    over one shared 100,000-particle cloud through B5 at B = 8 (float64)
    and B6 at B = 256 (float32), each against its plain version on the card;
    V5, a screen appended and read through B1 in count mode, the image
    exactly the scatter's.  One JSON line per sub-phase: the lattices'
    element kinds, the launches, the worst errors and their bounds;
14. path J, the JAX package's compiled entry points as CUDA graphs
    (``lynx_tpu_torch.graphs``): J1, the flagship read through
    ``functional.track_jit`` at B = 1 and 8, one capture each, the image
    equal to eager ``track``'s, re-tuning k1 with no new capture, eager
    against replay in turns, the graph's kernels and B1's among them; J2,
    B1's fallback decided on the card (a spot wider than the window, eager
    and replayed: the scatter's image, the device counter one a read, B1's
    completion against its plain version); J3, path T's tuner graphed
    against the eager loop; J4, ``tune_until`` with its device predicate,
    the same stop step as the eager loop and its host reads; J5, a random
    lattice with cavities captured at zero voltage and replayed at non-zero
    voltages against eager ``track`` in float64; J6, the gradient through
    ``track_jit`` (forward and backward captured) against eager; J7, the Gym
    adapter's graphed step and reset against eager ones;
15. path J continued, the JAX package's last jitted sites captured: J8,
    PPO's ``collect_and_update`` as one graph at R1's 100,000 envs (16 B3
    nodes) and at 512 (the dense route), against the eager step with the
    same capturable Adam and the first update against R1's; J9, metrics
    logged from a replay (``batched_step`` with ``log_metrics``, a PPO
    update); J10, B5 and B6 captured (the env's kernel route, path A's
    lattice); J11, the parallel layer captured on path M's 1 x 1 mesh
    (``track_jit`` inside the mesh, the train step, ``pipeline_track``,
    ``multichip_tuning``); J12, an active aperture captured (F4); J13, the
    examples' jits (``image_tuning``'s loss and gradient,
    ``emittance_measurement``'s measure, ``optimize_speed``'s stages,
    ``profiling.benchmark``).  R1, R3's image_tuning, O and M keep their
    eager forms (``graph=False``) as the records J replays against;
16. print the kernels' JSON line and, last, the ``{"ok": true, ...}`` line.

Each kernel is timed at its path's shape beside its plain version and its
bound (``bound``: the larger of its bytes over the card's memory rate and
its float32 operations over the card's peak outside the tensor cores; for
B6, whose float Gram runs on the tensor cores in three bf16 parts, the
Gram's operations at the bf16 tensor-core peak times three, plus its
planes' at the float32 peak: ``gram_bound``; for both B7 kernels the
bytes of a count histogram, ``hist_bound``, with the int8 operations that
the onehot read issues, counted from its buckets, at the dense int8
tensor-core peak printed beside it as that formulation's own floor,
``onehot_floor``); B2
also beside ``torch.bmm`` of the same operands, B1 and B7 beside
``torch.bincount`` of the in-window pairs, the one PyTorch call that
computes their function, timed here as a yardstick and never called by the
port.

It imports neither JAX nor ``lynx_tpu``, nor gymnasium or matplotlib.
"""

import contextlib
import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from lynx_tpu_torch.benchmarks.timing import PROFILER_TALLY, cuda_ms, device_launches, device_ms

N_PARTICLES = 100_000
WINDOW = (952, 256)  # the flagship kernel window, after swap and rounding
# Moved particles allowed between the GPU and CPU images: the two sum the
# f32 transfer-map products in other orders, so a particle within an ulp of
# a bin edge may land one bin over (each move adds 2 to the L1 distance).
MAX_MOVED = 20

SWEEP_BATCH = 100_000  # settings in paths S and T (the JAX package's bench sweep)
SWEEP_STEPS = 10
LATTICE_BATCH = 100_000  # path L's sweep of the full ARES lattice
LATTICE_CHECK_BATCH = 2048  # the full lattice's plan in the B3/B4 checks
FODO_CELLS, FODO_BATCH = 150, 16_384  # fault C1: B4 on 901 entries in double
PUSH_BATCH, PUSH_PARTICLES = 100, 10_000  # path P
KERNEL_LIBRARIES = ("window_histogram", "particle_apply", "moment_sweep", "moment_sweep_bwd",
                    "particle_moment_sweep", "packed_gram", "hist_ab")

# Bounds of B2-B4 against their plain versions.  Errors are relative to the
# largest entry of the compared quantity: per setting for moments and
# particles, over the batch for a parameter's cotangent.
# Double against double differ only in rounding order (and FMA contraction).
DOUBLE_RTOL = 1e-12
# Float kernels against the double plain version on the same (rounded)
# inputs: float rounding through ~10 composed maps with entries up to ~30.
FLOAT_RTOL = {"B2": 1e-5, "B3": 1e-5, "B4 moments": 1e-4, "B4 values": 1e-3}
# The full ARES lattice's plan composes 96 maps over 42 m (|k1| up to 3):
# ten times path S's maps, and ten times the float rounding (the plain
# version's own float error on it is printed beside the kernels').
FLOAT_RTOL_LATTICE = {"B3": 1e-4, "B4 moments": 1e-3, "B4 values": 1e-3}
# d/dk1 near k1 = 0: the reference formula's derivative cancels there
# (L cos(kL) - sin(kL)/k, absolute error ~ eps L / |k1|; at k1 = 0 the
# 1e-12 perturbation gives kL ~ 1e-7), so forward mode (B4) and reverse
# mode (the plain version) agree only to a few per cent of the entry in
# double at k1 = 0 (the cancelling difference, ~6e-16 L, carries ~2e-17 L of
# rounding) and share no digit in float at |k1| < ~1e-2.  Entries with
# |k1| < K1_SMALL are held apart: in double to K1_SMALL_RTOL of the entry,
# in float only to being finite.
K1_SMALL = 0.05  # 1/m^2
K1_SMALL_RTOL = 0.1
# The energy cotangent is held per setting to the moments' bound of its own
# value.  On a tape with a kind of the full lattice that bound gains
# SPREAD_FACTOR times the plain version's own spread: an inactive cavity's
# map depends on the energy only through r56, and its other cells'
# derivatives are differences of terms that cancel exactly (Ei / Ef at
# Ef = Ei), whose rounding can outweigh the true value.  The plain
# version's forward and reverse modes then differ per setting by as much
# as B4 (dual numbers, a forward mode) differs from the reverse mode (host
# build, 1,037 settings: 2.7e-7 of the value both, B4 against the forward
# mode 5.9e-13).  The spread is the largest |difference| over the batch
# between the plain version's reverse mode and its forward mode (double)
# or the plain version run in float (float); it is printed beside B4's.
# C1's chain of 901 maps of an unstable lattice (|T| up to ~1e34) carries the
# same kind of spread: the plain version's moments' cotangents from maps
# built on the host and on the card differ by 6.1e-11 per setting (an
# H100), so B4 there is held to SPREAD_FACTOR times that spread, measured
# in the run.
SPREAD_FACTOR = 10
# Path S: observations of the GPU route (B3, float) against the CPU dense
# route (float), relative to each observed column's largest |value|.
OBS_RTOL = 1e-4
# Path T: the first step's gradient through B3/B4 (float) against autograd
# of the plain version in double, relative to each column's largest |value|.
GRAD_RTOL = 1e-3

# The card's peaks for the kernels' bounds (NVIDIA's data sheet of the H100
# SXM at its 700 W limit): device memory, and float32 outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense, FP32 accumulation
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations
# Device times of the redesigned kernels' previous designs, as chip_smoke.py
# measured them (PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700 W):
# printed beside the new ones, never compared against.
PARENT_DEVICE_MS = {"B1": 0.00362, "B7 twolevel": 0.01284}
GRAM_PARTS = 3  # B6's float Gram: q in three bf16 parts, each a tensor-core product

# The particle moment sweep, kernels B5 and B6: one shared cloud of
# MOMENT_PARTICLES (paths K and A), ODD_PARTICLES in the checks.
MOMENT_PARTICLES = 100_000
ODD_PARTICLES = 100_003
SMALL_CLOUD = 300  # B5 on fewer particles than one block's span (512 in float, 256 in double)
ENV_KERNEL_BATCHES = (256, 8)  # path K: B6 at the JAX bench's PARTICLE_KERNEL_BATCH, B5
APERTURE_BATCHES = (32, 256)  # path A: benchmarks/aperture_sweep_ab.py's B
CROSSOVER_BATCHES = (8, 16, 32, 64, 128, 256)
# Bounds of B5 and B6 against their plain versions: second-moment sums
# relative to each setting's largest, first-moment sums relative to
# sqrt(W max_r s2[r, r]), the size Cauchy-Schwarz gives a first-moment sum
# (those of a centred cloud are themselves rounding noise).  In double the
# weight sums are equal.
MOMENT_DOUBLE_RTOL = 1e-12
# In float against the double plain version on the same rounded inputs:
# float sums of ~1e5 products, and mask flips: a particle within an ulp of
# an aperture edge may land on the other side, which moves its setting's
# weight sum by 1 and its second moments by ~1e-5 relative at these widths.
# MAX_FLIPS bounds the net change of survivors per setting.
MOMENT_FLOAT_RTOL = 1e-4
MAX_FLIPS = 5
# Path K: method="kernel" (float) against method="moments" (float, exact
# algebra for the linear EA), relative to each column's largest |value|.
KERNEL_OBS_RTOL = 1e-4
# Path A: the sweep (float) against dense functional.track (float): mu and
# sigma relative to the plane's largest sigma, survivors within MAX_FLIPS.
APERTURE_RTOL = 1e-4

# Path R, the RL-training and tuning slice (lynx_tpu_torch.examples): PPO
# at the env's SWEEP_BATCH settings with the example's rollout, 3 updates
# (every env step through B3), and one update at the example's default of
# 512 envs (the dense route); the fidelity example at its B = 64 (B6) and at
# B = 8 (B5) on its 20,000 particles.
PPO_ROLLOUT = 16
PPO_UPDATES = 3
PPO_DEFAULT_ENVS = 512
FIDELITY_BATCHES = (64, 8)
FIDELITY_PARTICLES = 20_000
TUNING_STEPS = 300  # gradient_tuning's default
# The emittance fit's bound, that of the JAX package's tests/test_tuning.py.
EMITTANCE_RTOL = 0.01
# R2: a metric line's values (6 significant digits, means of the batch in
# float32) against the observation's means in double.
METRIC_RTOL = 2e-5


def flagship(torch, ares, ParticleBeam, batch, device, seed, sigma_x=1.75e-4):
    """The flagship segment (screen active, working-point k1) and a
    100k-particle beam for ``batch`` settings (of ``sigma_x`` in m)."""
    segment = ares.ares_ea_segment(device=device)
    shape = (batch,)
    if batch > 1:
        segment = segment.broadcast(shape)
    segment.AREABSCR1.is_active = True
    for name, k1 in ares.FLAGSHIP_K1.items():
        getattr(segment, name).k1 = torch.full(shape, k1, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    beam = ParticleBeam.from_parameters(
        num_particles=N_PARTICLES,
        sigma_x=torch.full(shape, sigma_x),
        sigma_y=torch.full(shape, 1.75e-4),
        sigma_xp=torch.full(shape, 2e-5),
        sigma_yp=torch.full(shape, 2e-5),
        sigma_s=torch.full(shape, 8e-6),
        sigma_p=torch.full(shape, 2e-3),
        energy=torch.full(shape, 1.073e8),
        generator=generator,
        device=device,
    )
    return segment, beam


def check_kernel_cases(torch, hist):
    """Phase 3: B1 against its plain version on the card; max |error|."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    win_x, win_y = WINDOW

    def random_indices(batch, n):
        lx = torch.randint(-1, win_x, (batch, n), generator=gen, device="cuda", dtype=torch.int32)
        ly = torch.randint(-1, win_y, (batch, n), generator=gen, device="cuda", dtype=torch.int32)
        return lx, ly

    edge_x = torch.tensor([0, win_x - 1, 0, win_x - 1, -1], device="cuda", dtype=torch.int32)
    edge_y = torch.tensor([0, 0, win_y - 1, win_y - 1, 5], device="cuda", dtype=torch.int32)
    cases = {
        "flagship B=1": random_indices(1, N_PARTICLES),
        "flagship B=8": random_indices(8, N_PARTICLES),
        "N not a multiple of the block": random_indices(2, N_PARTICLES + 3),
        "all masked": (
            torch.full((2, 1000), -1, device="cuda", dtype=torch.int32),
            torch.full((2, 1000), -1, device="cuda", dtype=torch.int32),
        ),
        "indices at 0 and win-1": (
            edge_x.repeat(3, 200).contiguous(),
            edge_y.repeat(3, 200).contiguous(),
        ),
    }
    worst = 0.0
    for label, (lx, ly) in cases.items():
        counts = hist.window_histogram(lx, ly, None, win_x, win_y)
        counts_ref = hist.window_histogram_reference(lx, ly, None, win_x, win_y)
        torch.cuda.synchronize()
        if counts.dtype != torch.int32 or not torch.equal(counts, counts_ref):
            raise AssertionError(f"B1 count mode differs from its plain version: {label}")
        weights = torch.rand(lx.shape, generator=gen, device="cuda", dtype=torch.float32)
        summed = hist.window_histogram(lx, ly, weights, win_x, win_y).double()
        summed_ref = hist.window_histogram_reference(lx, ly, weights.double(), win_x, win_y)
        torch.cuda.synchronize()
        # f32 atomics sum in a varying order: 1e-5 relative, per bin.
        if not torch.allclose(summed, summed_ref, rtol=1e-5, atol=0.0):
            raise AssertionError(f"B1 weighted mode exceeds 1e-5 relative: {label}")
        error = float((summed - summed_ref).abs().max())
        worst = max(worst, error)
        print(f"B1 check {label}: shape {tuple(lx.shape)} count exact,"
              f" weighted max |err| {error:.3e}, mass {int(counts.sum())}")
    return worst


# -- kernel B1's fused read -------------------------------------------------------

FLAGSHIP_BINS = (2040, 2448)  # the flagship image, (-y, x) binned
LATTICE_WINDOW = (1848, 512)  # path L's AREABSCR1 window, rounded
READ_RANGES = (-3.4e-3, 3.4e-3, -4.1e-3, 4.1e-3)
READ_RTOL = 1e-5  # weighted mode: float atomics sum in any order


def read_inputs(torch, gen, batch, n, sigma, bins=FLAGSHIP_BINS, ranges_on_card=True):
    """A screen read's operands at ``bins`` as the screen passes them: x
    contiguous, y a column of a (B, N, 7) particle array (stride 7),
    weights with a tenth dead, ranges 0-d CUDA tensors (or Python floats);
    a Gaussian spot about the image's centre, sigma in bins, each row's
    centre moved by 10 bins."""
    lo_x, hi_x, lo_y, hi_y = READ_RANGES
    px, py = (hi_x - lo_x) / bins[0], (hi_y - lo_y) / bins[1]
    shift = 10.0 * torch.arange(batch, device="cuda")[:, None]
    x = lo_x + px * (bins[0] / 2 + shift + sigma[0] * torch.randn((batch, n), generator=gen,
                                                                  device="cuda"))
    particles = torch.randn((batch, n, 7), generator=gen, device="cuda")
    particles[..., 0] = lo_y + py * (bins[1] / 2 - shift + sigma[1] * particles[..., 0])
    weights = (torch.rand((batch, n), generator=gen, device="cuda") > 0.1).float()
    ranges = tuple(torch.tensor(v, device="cuda") for v in READ_RANGES)
    return x, particles[..., 0], weights, ranges if ranges_on_card else READ_RANGES


def read_edges(torch, bins):
    """Row 0: particles on a grid of interior bin edges formed on the card
    in float32, on lo and hi in x (the window spans x), one ulp past hi, at
    +-inf and NaN, one dead; row 1: only NaN."""
    lo_x, hi_x, lo_y, hi_y = (torch.tensor(v, device="cuda") for v in READ_RANGES)
    ex = lo_x + (hi_x - lo_x) / bins[0] * torch.arange(900, 940, device="cuda")
    ey = lo_y + (hi_y - lo_y) / bins[1] * torch.arange(1100, 1140, device="cuda")
    gx, gy = torch.meshgrid(ex, ey, indexing="ij")
    special = torch.tensor([float("nan"), float("inf"), -float("inf")], device="cuda")
    x0 = torch.cat([gx.reshape(-1), torch.stack([lo_x, hi_x, torch.nextafter(hi_x, hi_x + 1)]),
                    special, ex[:4]])
    y0 = torch.cat([gy.reshape(-1), ey[:3], ey[:3], special, ey[:1]])
    x = torch.stack([x0, torch.full_like(x0, float("nan"))])
    weights = torch.ones_like(x)
    weights[0, -1] = 0.0
    return x, torch.stack([y0, y0]), weights, (lo_x, hi_x, lo_y, hi_y)


def plain_read(hist, x, y, weights, ranges, bins, window, binary):
    """B1's plain versions: the two passes' and the completion's."""
    image, ox, oy, fits = hist.windowed_read_reference(x, y, weights, ranges, bins, window, binary)
    return hist.complete_read_reference(x, y, weights, ranges, bins, image, fits), ox, oy, fits


def check_read(torch, hist, label, operands, bins, window, binary):
    """B1's read against its plain version on the same CUDA tensors:
    origins and fits equal, the image exact in count mode (within
    READ_RTOL per cell weighted; the scatter's where a row misfits); max
    |error|."""
    x, y, weights, ranges = operands
    image, ox, oy, fits = hist.windowed_read(x, y, weights, ranges, bins, window, binary)
    ref = plain_read(hist, x, y, weights, ranges, bins, window, binary)
    torch.cuda.synchronize()
    if not (torch.equal(ox, ref[1]) and torch.equal(oy, ref[2]) and torch.equal(fits, ref[3])):
        raise AssertionError(f"B1 read: origins or fits differ from the plain version: {label}")
    if binary and not torch.equal(image, ref[0]):
        raise AssertionError(f"B1 read: count-mode image differs from the plain version: {label}")
    if not torch.allclose(image, ref[0], rtol=READ_RTOL, atol=0.0):
        raise AssertionError(f"B1 read: weighted image past {READ_RTOL} relative: {label}")
    return float((image - ref[0]).abs().max()), fits


def check_read_cases(torch, hist, card):
    """Phase 3, B1's fused read at the flagship's shapes (B = 1 and 8, N =
    100,000, float32, the screen's operands), count and weighted; on path
    L's window, on bin edges, NaN and +-inf with an all-dead row, on a spot
    past its window (fits False), with Python-float ranges and on N =
    100,003; max |error|."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    window = WINDOW
    spot = (80.0, 20.0)  # sigma in bins: the flagship spot's extent in the window
    worst = 0.0
    for batch in (1, 8):
        operands = read_inputs(torch, gen, batch, N_PARTICLES, spot)
        for binary in (True, False):
            error, fits = check_read(torch, hist, f"B={batch}", operands, FLAGSHIP_BINS, window,
                                     binary)
            worst = max(worst, error)
            if not bool(fits.all()):
                raise AssertionError("B1 read: the flagship-shaped spot does not fit")
        print(f"B1 read check B={batch}: count exact, weighted max |err| {error:.3e}")
    others = {  # label: (operands, window, every row fits)
        "path L's window": (read_inputs(torch, gen, 1, N_PARTICLES, (150.0, 40.0)),
                                      LATTICE_WINDOW, True),
        "bin edges, NaN, +-inf, a dead row": (read_edges(torch, FLAGSHIP_BINS),
                                              (FLAGSHIP_BINS[0], window[1]), True),
        "a spot past its window": (read_inputs(torch, gen, 2, 20_000, (400.0, 100.0)), window,
                                   False),
        "Python-float ranges": (read_inputs(torch, gen, 2, 20_000, spot, ranges_on_card=False),
                                window, True),
        "N = 100,003": (read_inputs(torch, gen, 3, ODD_PARTICLES, spot), window, True),
    }
    for label, (operands, win, fit) in others.items():
        for binary in (True, False):
            error, fits = check_read(torch, hist, label, operands, FLAGSHIP_BINS, win, binary)
            worst = max(worst, error)
        if bool(fits.all()) != fit:
            raise AssertionError(f"B1 read: {label}: fits {fits.tolist()}")
        print(f"B1 read check {label}: fits {fits.tolist()}; count exact, weighted max |err|"
              f" {error:.3e}")
    clusters = {c: hist_ab_max_clusters(c) for c in (8, 16)}
    print(f"B7 twolevel at the harness's window {WINDOW}: cudaOccupancyMaxActiveClusters"
          f" {clusters} (cluster size: clusters; card {card})")
    return worst


def hist_ab_max_clusters(cluster):
    from lynx_tpu_torch.benchmarks import hist_ab

    return hist_ab.twolevel_max_clusters(*WINDOW, cluster)


def screen_read_args(segment, beam):
    """The arguments of the AREABSCR1 read after ``segment.track(beam)``."""
    from lynx_tpu_torch.accelerator.screen import screen_histogram_args

    segment.track(beam)
    screen = segment.AREABSCR1
    return screen_histogram_args(screen.get_read_beam(), screen.resolution, screen.pixel_size,
                                 screen.binning, histogram_window=screen.histogram_window)


def composed_forward(torch, hist):
    """The composed windowed read, the yardstick of the fused one: the
    prologue in PyTorch (``window_prologue``), kernel B1's (lx, ly) count
    core into a zeroed window, then the crop and ``_place``."""
    def forward(x, y, weights, ranges, bins, window, binary_weights):
        (x_lo, x_hi, y_lo, y_hi), (nx, ny), (win_x, win_y) = ranges, bins, window
        lx, ly, ox, oy, fits = hist.window_prologue(x, y, weights, ranges, bins, window)
        if not bool(fits.all()):  # the composed read decides on the host
            hist._fallback_counter(x.device).add_(1)
            return hist.weighted_histogram_2d(x, y, weights, (x_lo, x_hi), (y_lo, y_hi), bins)
        batch_shape, n = x.shape[:-1], x.shape[-1]
        w_b = torch.broadcast_to(weights, x.shape)
        kernel_weights = None
        if not binary_weights:
            kernel_weights = w_b.reshape(-1, n).to(torch.float32).contiguous()
        wins = hist.window_histogram(lx, ly, kernel_weights, win_x, win_y).to(w_b.dtype)
        wins = wins[:, : min(win_x, nx), : min(win_y, ny)]
        return hist._place(wins, ox, oy, nx, ny).reshape(*batch_shape, nx, ny)

    return forward


@contextlib.contextmanager
def composed_route(hist, on=True):
    """Route the windowed read through the composed read while on."""
    import torch

    fused = hist._windowed_forward
    if on:
        hist._windowed_forward = composed_forward(torch, hist)
    try:
        yield
    finally:
        hist._windowed_forward = fused


def device_kernels(launches):
    """Kernels and memsets in a ``device_launches`` count (copies not)."""
    return sum(count for name, count in launches.items() if not name.startswith("Memcpy"))


def time_read(torch, hist, args, card, label):
    """The windowed read's device time (all of its GPU work, from the
    coordinates to the image: the zeroing, B1's kernels, the fits
    reduction) through the fused read and through the composed read, in
    turns, beside the full-image scatter; B1's own kernels' time; device
    kernels a read; the read's floor (the image written once) and B1's
    bound (x, y, weights read once, the window written once)."""
    def read():
        return hist.screen_histogram_2d(**args)

    def scatter():
        return hist.weighted_histogram_2d(args["x"], args["y"], args["weights"], args["x_range"],
                                          args["y_range"], args["bins"])

    device, kernels, call = {"fused": [], "composed": []}, {}, {}
    for route in ("composed", "fused", "fused", "composed"):
        with composed_route(hist, route == "composed"):
            device[route].append(device_ms(read, 20))
    for route in ("fused", "composed"):
        with composed_route(hist, route == "composed"):
            kernels[route] = device_kernels(device_launches(read))
            call[route] = cuda_ms(read, 50)
    _, kernel_ms = device_ms(read, 20, kernel="windowed_read_")
    _, bins_ms = device_ms(read, 20, kernel="windowed_read_bins")
    scatter_ms = device_ms(scatter, 20)
    kernels["scatter"] = device_kernels(device_launches(scatter))
    x, w = args["x"], args["weights"]
    batch, n = x.numel() // x.shape[-1], x.shape[-1]
    (nx, ny), window = args["bins"], hist._window_shape(args["window"], *args["bins"])
    floor = batch * nx * ny * w.element_size() / HBM_BYTES_PER_S * 1e3
    kernel_bound = bound(nbytes(x, args["y"], w) + batch * window[0] * window[1] * w.element_size(),
                         x.numel())
    print(f"read {label} (window {window}): device time a read, fused"
          f" {device['fused'][0]:.5f} / {device['fused'][1]:.5f} ms, composed read"
          f" {device['composed'][0]:.5f} / {device['composed'][1]:.5f} ms (in turns: composed,"
          f" fused, fused, composed), full-image scatter {scatter_ms:.5f} ms; of the fused read B1's"
          f" kernels {kernel_ms:.5f} ms (its binning pass {bins_ms:.5f} ms; bound"
          f" {kernel_bound[0]:.5f} ms, {kernel_bound[1]});"
          f" the read's floor (the image written once) {floor:.5f} ms; device kernels a read:"
          f" fused {kernels['fused']}, composed {kernels['composed']}, scatter"
          f" {kernels['scatter']}; a call (CUDA events, 50 calls): fused {call['fused']:.4f} ms,"
          f" composed {call['composed']:.4f} ms; card {card}")
    if kernels["fused"] > 4:
        raise AssertionError(f"read {label}: the fused read issued {kernels['fused']} kernels")
    return dict(kernel_ms=kernel_ms, device=device, scatter_ms=scatter_ms, kernels=kernels,
                floor=floor, bound=kernel_bound)


# -- the batched-settings sweep: kernels B2, B3, B4 -----------------------------


def relative_error(torch, actual, expected, per_setting=True, exclude=None):
    """Max |actual - expected| relative to the largest |expected|: per
    setting (leading axis) or over the whole tensor; ``exclude`` masks
    settings out."""
    a, e = actual.detach().double(), expected.detach().double()
    if exclude is not None and e.dim():
        a, e = a[~exclude], e[~exclude]
    if e.numel() == 0:
        return 0.0
    if per_setting and e.dim():
        a, e = a.reshape(e.shape[0], -1), e.reshape(e.shape[0], -1)
        scale = e.abs().amax(dim=1).clamp_min(1e-300)
        return float(((a - e).abs().amax(dim=1) / scale).max())
    return float((a - e).abs().max() / e.abs().max().clamp_min(1e-300))


def sweep_lattice(torch, ltt, B, k1=None, static=False, seed=0):
    """A run over every ported element type on the card, float64: a
    quadrupole with per-setting k1 (default: |k1| from 0.5 to 5, alternating
    sign), tilt and misalignment, correctors and drifts, static (hoisted)
    neighbours, a marker and an inactive screen.  ``static`` makes every
    element batch-invariant."""
    gen = torch.Generator().manual_seed(seed)

    def u(low, high, *shape):
        x = low + (high - low) * torch.rand(shape, generator=gen, dtype=torch.float64)
        return x.cuda()

    f64 = dict(dtype=torch.float64, device="cuda")
    n = 1 if static else B
    if k1 is None:
        sign = 1.0 - 2.0 * (torch.arange(n, device="cuda") % 2)
        k1 = torch.linspace(0.5, 5.0, n, **f64) * sign
    return [
        ltt.Marker(**f64),
        ltt.Drift(torch.tensor([0.5], **f64), **f64),
        ltt.Quadrupole(torch.full((n,), 0.23, **f64), k1=k1, tilt=u(-0.2, 0.2, n),
                       misalignment=u(-2e-4, 2e-4, n, 2), **f64),
        ltt.Drift(torch.tensor([0.3], **f64), **f64),
        ltt.HorizontalCorrector(torch.full((n,), 0.1, **f64), angle=u(-1e-3, 1e-3, n), **f64),
        ltt.VerticalCorrector(torch.tensor([0.1], **f64), angle=torch.tensor([2e-4], **f64), **f64),
        ltt.Quadrupole(torch.tensor([0.2], **f64), k1=torch.tensor([3.0], **f64),
                       tilt=torch.tensor([0.05], **f64), **f64),
        ltt.Drift(u(0.1, 0.6, n), **f64),
        ltt.Screen(**f64),
    ]


def new_kind_lattice(torch, ltt, B, seed=3):
    """One batched element of each kind of the full lattice between static
    drifts, float64 on the card: a dipole with non-zero e1, e2, tilt, fint
    and gap and one at length 0, an RBend, a misaligned solenoid and one at
    k = 0, an inactive cavity with batched length, phase and frequency, an
    undulator and a custom map."""
    gen = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64, device="cuda")

    def u(low, high, *shape):
        x = low + (high - low) * torch.rand(shape or (B,), generator=gen, dtype=torch.float64)
        return x.cuda()

    kinds = [
        ltt.Dipole(u(0.2, 0.5), angle=u(-0.2, 0.2), e1=u(-0.05, 0.05), e2=u(-0.05, 0.05),
                   tilt=u(-0.1, 0.1), fringe_integral=u(0.3, 0.6),
                   fringe_integral_exit=u(0.3, 0.6), gap=u(0.01, 0.05), **f64),
        ltt.Dipole(torch.zeros(B, **f64), angle=u(-1e-3, 1e-3), tilt=u(-0.1, 0.1), **f64),
        ltt.RBend(u(0.2, 0.4), angle=u(-0.2, 0.2), gap=u(0.01, 0.03),
                  fringe_integral=u(0.3, 0.6), **f64),
        ltt.Solenoid(u(0.1, 0.3), k=u(-3.0, 3.0), misalignment=u(-2e-4, 2e-4, B, 2), **f64),
        ltt.Solenoid(u(0.1, 0.3), k=torch.zeros(B, **f64), **f64),
        ltt.Cavity(u(0.5, 1.5), voltage=torch.zeros(1, **f64), phase=u(-30.0, 30.0),
                   frequency=u(1e9, 3e9), **f64),
        ltt.Undulator(u(0.5, 2.0), **f64),
        ltt.CustomTransferMap(torch.eye(7, **f64) + 0.05 * u(-1.0, 1.0, B, 7, 7), **f64),
    ]
    elements = []
    for element in kinds:
        elements += [ltt.Drift(torch.tensor([0.3], **f64), **f64), element]
    return elements


TUNED_KINDS = ("Quadrupole", "HorizontalCorrector", "VerticalCorrector", "Solenoid", "Dipole")


def tune_lattice(torch, lattice, B, seed, requires_grad=False, kinds=TUNED_KINDS):
    """Per-setting values, in the lattice's dtype and on its device, of
    every quadrupole's k1 (|k1| from 0.5 to 3 1/m^2, either sign), every
    corrector's angle, both solenoids' k and every dipole's angle (its
    file value +-0.05 rad), of the element types in ``kinds``; returns the
    new tensors."""
    gen = torch.Generator().manual_seed(seed)

    def u(low, high):
        return low + (high - low) * torch.rand(B, generator=gen, dtype=torch.float64)

    tuned = []
    for element in lattice.elements:
        kind = type(element).__name__
        if kind not in kinds:
            continue
        if kind == "Quadrupole":
            sign = torch.where(torch.rand(B, generator=gen) < 0.5, -1.0, 1.0).double()
            field, value = "k1", sign * u(0.5, 3.0)
        elif kind in ("HorizontalCorrector", "VerticalCorrector"):
            field, value = "angle", u(-1e-3, 1e-3)
        elif kind == "Solenoid":
            field, value = "k", u(-2.0, 2.0)
        elif kind == "Dipole":
            field, value = "angle", element.angle.double().cpu() + u(-0.05, 0.05)
        else:
            continue
        old = getattr(element, field)
        value = value.to(old.dtype).to(old.device).requires_grad_(requires_grad)
        setattr(element, field, value)
        tuned.append(value)
    return tuned


def random_moments(torch, B, gen):
    mu = torch.cat(
        [1e-4 * torch.randn((B, 6), generator=gen, dtype=torch.float64, device="cuda"),
         torch.ones((B, 1), dtype=torch.float64, device="cuda")], dim=1)
    a = 1e-4 * torch.randn((B, 7, 7), generator=gen, dtype=torch.float64, device="cuda")
    a[:, 6, :] = 0.0
    return mu, a @ a.transpose(1, 2)


def sweep_cases(torch, ltt, fused, env):
    """(label, entries, values, energy) of the B3/B4 checks, float64 on the
    card."""
    cases = []

    def add(label, elements, B, energy):
        plan = fused.plan_run(
            [fused.element_map_builder(el) for el in elements], energy,
            lambda x: torch.broadcast_to(x, (B,)).reshape(B),
        )
        entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
        values = [v.double() for _, _, vs in plan for v in vs]
        full = torch.broadcast_to(energy, (B,)).double().contiguous()
        cases.append((label, entries, values, full))

    f64 = dict(dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    magnets = torch.rand((SWEEP_BATCH, 5), generator=gen, device="cuda") * 2 - 1
    tuned = env._batched_tuned_segment(magnets)
    add(f"path S/T plan, B={SWEEP_BATCH}", list(tuned.flattened().elements), SWEEP_BATCH,
        torch.tensor([1.073e8], **f64))
    add("ragged B=1037, tilt and misalignment", sweep_lattice(torch, ltt, 1037), 1037,
        torch.tensor([1.073e8], **f64))
    add("k1 = 0 on every setting", sweep_lattice(torch, ltt, 256, k1=torch.zeros(256, **f64)),
        256, torch.tensor([1.073e8], **f64))
    add("batched energy (every entry dynamic)", sweep_lattice(torch, ltt, 300), 300,
        torch.linspace(0.9e8, 1.2e8, 300, **f64))
    add("all-const plan", sweep_lattice(torch, ltt, 300, static=True), 300,
        torch.tensor([1.073e8], **f64))
    add("one batched element of each new kind", new_kind_lattice(torch, ltt, 1037), 1037,
        torch.tensor([1.073e8], **f64))
    add("one of each new kind, batched energy (every entry dynamic)",
        new_kind_lattice(torch, ltt, 300), 300, torch.linspace(0.9e8, 1.2e8, 300, **f64))
    from lynx_tpu_torch.models import ares

    lattice = ares.ares_lattice(dtype=torch.float64, device="cuda")
    tune_lattice(torch, lattice, LATTICE_CHECK_BATCH, seed=13)
    add(f"full ARES lattice (path L's plan), B={LATTICE_CHECK_BATCH}", list(lattice.elements),
        LATTICE_CHECK_BATCH, torch.tensor([1.073e8], **f64))
    cases.append(("empty plan", (), [], torch.full((129,), 1.073e8, **f64)))
    return cases


def quad_k1_slots(ft, entries):
    """Indices of the flat values that are a dynamic quadrupole's k1."""
    slots, offset = set(), 0
    for kind, meta, count in entries:
        if kind == "dyn" and getattr(meta, "tape_kind", None) == ft.TAPE_QUAD:
            slots.add(offset + 1)
        offset += count
    return slots


def cotangent_errors(torch, ft, entries, values, kernel, plain, k1_rtol):
    """Worst relative errors (values, moments, small-k1 entries, energy) of
    B4's cotangents against the plain version's: the moments' (d_mu, d_cov)
    and the energy's per setting (the energy's bound: ``energy_ratio``).  A
    dynamic parameter's cotangent is held relative
    to the setting's largest parameter cotangent (units differ, as between
    the moments' entries, and some, such as d/dtilt of a quadrupole at
    k1 = 0, vanish); const-cell cotangents, summed over the batch, relative
    to the largest of them.  d/dk1 entries with |k1| < K1_SMALL are held
    apart: to ``k1_rtol`` of the entry, or, if that is None, to being
    finite."""
    k_values, *k_rest = kernel
    p_values, *p_rest = plain
    if not bool(all(torch.isfinite(t).all() for t in [*k_values, *k_rest])):
        raise AssertionError("B4: a cotangent is not finite")
    slots = quad_k1_slots(ft, entries)
    kinds = [kind for kind, _, count in entries for _ in range(count)]
    dyn_errors, dyn_scales, const_errors, const_scales = [], [], [], []
    worst_small = 0.0
    for index, (got, want) in enumerate(zip(k_values, p_values)):
        want = want.reshape(got.shape).double()
        error = (got.double() - want).abs()
        if kinds[index] == "const":
            const_errors.append(error.max())
            const_scales.append(want.abs().max())
            continue
        if index in slots:
            small = values[index].abs() < K1_SMALL
            if bool(small.any()):
                ratio = float((error[small] / want.abs()[small].clamp_min(1e-300)).max())
                worst_small = max(worst_small, ratio)
                if k1_rtol is not None and ratio > k1_rtol:
                    raise AssertionError(
                        f"B4: d/dk1 at |k1| < {K1_SMALL} is {ratio:.2e} of the entry off"
                        f" (bound {k1_rtol})"
                    )
            error = torch.where(small, 0.0, error)
        dyn_errors.append(error)
        dyn_scales.append(want.abs())
    worst_values = 0.0
    if dyn_errors:
        scale = torch.stack(dyn_scales, dim=1).amax(dim=1).clamp_min(1e-300)
        worst_values = float((torch.stack(dyn_errors, dim=1).amax(dim=1) / scale).max())
    if const_errors:
        scale = float(torch.stack(const_scales).max().clamp_min(1e-300))
        worst_values = max(worst_values, float(torch.stack(const_errors).max()) / scale)
    worst_energy = relative_error(torch, k_rest[0], p_rest[0])
    worst_moments = max(relative_error(torch, g, w) for g, w in zip(k_rest[1:], p_rest[1:]))
    return worst_values, worst_moments, worst_small, worst_energy


def plain_energy_forward(torch, ft, entries, values, energy, mu, cov, dmu, dcov):
    """The plain version's energy cotangent in forward mode: the moments'
    derivatives along the energy, contracted with their cotangents per
    setting (each setting's energy moves only its own moments)."""
    import torch.autograd.forward_ad as fwAD

    B = energy.shape[0]
    with fwAD.dual_level():
        dual = fwAD.make_dual(energy, torch.ones_like(energy))
        outputs = ft._table_reference_sweep(entries, [v.detach() for v in values], dual, mu, cov)
        tmu, tcov = (fwAD.unpack_dual(t).tangent for t in outputs)
    total = torch.zeros_like(energy)
    if tmu is not None:
        total = total + (dmu * tmu).sum(dim=1)
    if tcov is not None:
        total = total + (dcov * tcov).reshape(B, -1).sum(dim=1)
    return total


def energy_ratio(torch, got, want, rtol, other=None):
    """The energy cotangent's worst error per setting in units of its bound:
    ``rtol`` of the setting's |value|, plus, where ``other`` (the plain
    version computed another way) is given, SPREAD_FACTOR times the plain
    version's own spread, max |other - want| over the batch.  Returns (the
    ratio, the spread relative to the batch's largest |value|)."""
    got, want = got.detach().double(), want.detach().double()
    if want.numel() == 0:
        return 0.0, 0.0
    spread = 0.0
    if other is not None:
        spread = float((other.detach().double() - want).abs().max())
    error = (got - want).abs()
    bound = (rtol * want.abs() + SPREAD_FACTOR * spread).clamp_min(1e-300)
    return float((error / bound).max()), spread / float(want.abs().max().clamp_min(1e-300))


def check_sweep_kernels(torch, ltt, ft, fused, env):
    """Phase 3: B3 and B4 against their plain versions on the card.  Returns
    B3's and B4's max |error| in float at the paths' shape."""
    worst_abs = {}
    gen = torch.Generator(device="cuda").manual_seed(12)
    for label, entries, values, energy in sweep_cases(torch, ltt, fused, env):
        B = energy.shape[0]
        mu, cov = random_moments(torch, B, gen)
        dmu = torch.randn((B, 7), generator=gen, dtype=torch.float64, device="cuda")
        dcov = torch.randn((B, 7, 7), generator=gen, dtype=torch.float64, device="cuda")
        args = (entries, values, energy, mu, cov)

        # double against double
        # A tape with a kind of the full lattice: the energy's bound gains
        # the plain version's own spread (SPREAD_FACTOR).
        full = bool(entries) and ft._tape(entries, energy.device).full
        kernel, plain = ft.moment_sweep(*args), ft._table_reference_sweep(*args)
        b3 = max(relative_error(torch, k, p) for k, p in zip(kernel, plain))
        kernel_bwd = ft.moment_sweep_bwd(*args, dmu, dcov)
        plain_bwd = ft._reference_sweep_vjp(*args, dmu, dcov)
        b4 = cotangent_errors(torch, ft, entries, values, kernel_bwd, plain_bwd, K1_SMALL_RTOL)
        forward = plain_energy_forward(torch, ft, *args, dmu, dcov) if full else None
        energy64 = energy_ratio(torch, kernel_bwd[1], plain_bwd[1], DOUBLE_RTOL, forward)
        torch.cuda.synchronize()
        if b3 > DOUBLE_RTOL or max(b4[:2]) > DOUBLE_RTOL or energy64[0] > 1:
            raise AssertionError(f"B3/B4 in double exceed {DOUBLE_RTOL}: {label}: {b3}, {b4},"
                                 f" energy {energy64}")

        # float against double, on the same rounded inputs
        f32 = [values, energy, mu, cov, dmu, dcov]
        f32 = [[v.float() for v in f32[0]]] + [t.float() for t in f32[1:]]
        f64 = [[v.double() for v in f32[0]]] + [t.double() for t in f32[1:]]
        kernel = ft.moment_sweep(entries, *f32[:4])
        plain = ft._table_reference_sweep(entries, *f64[:4])
        b3f = max(relative_error(torch, k, p) for k, p in zip(kernel, plain))
        plain_f = max(relative_error(torch, k, p) for k, p in
                      zip(ft._table_reference_sweep(entries, *f32[:4]), plain))
        bounds = FLOAT_RTOL_LATTICE if label.startswith("full ARES lattice") else FLOAT_RTOL
        kernel_bwd = ft.moment_sweep_bwd(entries, *f32)
        plain_bwd = ft._reference_sweep_vjp(entries, *f64)
        b4f = cotangent_errors(torch, ft, entries, f64[0], kernel_bwd, plain_bwd, None)
        plain_float = ft._reference_sweep_vjp(entries, *f32)[1] if full else None
        energy32 = energy_ratio(torch, kernel_bwd[1], plain_bwd[1], bounds["B4 moments"],
                                plain_float)
        torch.cuda.synchronize()
        if (b3f > bounds["B3"] or b4f[0] > bounds["B4 values"]
                or b4f[1] > bounds["B4 moments"] or energy32[0] > 1):
            raise AssertionError(f"B3/B4 in float exceed their bounds: {label}: {b3f}, {b4f},"
                                 f" energy {energy32}")
        if label.startswith("path S/T"):
            worst_abs["B3"] = max(float((k.double() - p).abs().max()) for k, p in zip(kernel, plain))
            # Over the cotangents the bounds hold (d/dk1 at |k1| < K1_SMALL apart).
            slots = quad_k1_slots(ft, entries)
            errors = []
            for index, (k, w) in enumerate(zip(kernel_bwd[0], plain_bwd[0])):
                error = (k.double().reshape(w.shape) - w).abs()
                if index in slots:
                    error = error[f64[0][index].abs() >= K1_SMALL]
                errors.append(float(error.max()) if error.numel() else 0.0)
            errors += [float((k.double() - w).abs().max())
                       for k, w in zip(kernel_bwd[1:], plain_bwd[1:])]
            worst_abs["B4"] = max(errors)
        spreads = (f" (the plain version's own spread {energy64[1]:.2e} forward against reverse"
                   f" mode, {energy32[1]:.2e} float against double, of the largest; within"
                   f" {energy64[0]:.2f} and {energy32[0]:.2f} of the bounds)" if full else "")
        print(f"B3/B4 check {label}: B={B}, {len(entries)} entries; double: B3 {b3:.2e},"
              f" B4 values {b4[0]:.2e} moments {b4[1]:.2e} energy {b4[3]:.2e}; float vs double:"
              f" B3 {b3f:.2e} (the plain version's own {plain_f:.2e}), B4 values {b4f[0]:.2e}"
              f" moments {b4f[1]:.2e} energy {b4f[3]:.2e} per setting{spreads}"
              + (f"; d/dk1 at |k1| < {K1_SMALL}: double {b4[2]:.2e} of the entry,"
                 f" float {b4f[2]:.2e} (finite)" if b4[2] or b4f[2] else ""))
    return worst_abs


def push_inputs(torch, fused, tbl, ft, B, N, seed):
    """The composed EA maps of B settings (spread k1) as B2 takes them, and
    (B, N, 7) particles, float64 on the card."""
    from lynx_tpu_torch.models import ares

    f64 = dict(dtype=torch.float64, device="cuda")
    segment = ares.ares_ea_segment(dtype=torch.float64, device="cuda").broadcast((B,))
    spread = torch.linspace(0.8, 1.2, B, **f64)
    for name, k1 in ares.FLAGSHIP_K1.items():
        getattr(segment, name).k1 = k1 * spread
    energy = torch.full((B,), 1.073e8, **f64)
    total = None
    for element in segment.flattened().elements:
        params, build = fused.element_map_builder(element)
        T = build([torch.broadcast_to(p, (B,)) for p in params], energy)
        total = T if total is None else tbl.compose(T, total)
    layout, _ = ft._split_table(total)
    matrix = torch.stack([tbl.broadcast_cell(c, (B,), torch.float64, "cuda")
                          for row in total for c in row], dim=-1).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    particles = torch.cat(
        [1e-4 * torch.randn((B, N, 6), generator=gen, **f64), torch.ones((B, N, 1), **f64)],
        dim=-1)
    return layout, matrix, particles


def check_push_kernel(torch, ft, fused, tbl):
    """Phase 3: B2 and its backward against the plain version (and its
    autograd) on the card.  Returns B2's max |error| in float at path P's
    shape."""
    worst_abs = 0.0
    for label, B, N in ((f"path P shape B={PUSH_BATCH}, N={PUSH_PARTICLES}", PUSH_BATCH,
                         PUSH_PARTICLES), ("ragged B=17, N=1001", 17, 1001)):
        layout, matrix, particles = push_inputs(torch, fused, tbl, ft, B, N, seed=B)
        dynamic = torch.tensor([not isinstance(c, float) for row in layout for c in row],
                               device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(13)
        d_out = torch.randn(particles.shape, generator=gen, dtype=torch.float64, device="cuda")
        errors = {}
        for dtype in (torch.float64, torch.float32):
            m = matrix.to(dtype).requires_grad_(True)
            p = particles.to(dtype).requires_grad_(True)
            out = ft._ParticleApply.apply(layout, m, p)
            d_m, d_p = torch.autograd.grad(out, (m, p), d_out.to(dtype))
            m64 = m.detach().double().requires_grad_(True)
            p64 = p.detach().double().requires_grad_(True)
            ref = ft.particle_apply_reference(layout, m64, p64)
            r_m, r_p = torch.autograd.grad(ref, (m64, p64), d_out.to(dtype).double())
            errors[dtype] = (
                relative_error(torch, out, ref),
                relative_error(torch, d_p, r_p),
                relative_error(torch, d_m[:, dynamic], r_m[:, dynamic]),
            )
            if dtype == torch.float32 and B == PUSH_BATCH:
                worst_abs = float((out.detach().double() - ref.detach()).abs().max())
        torch.cuda.synchronize()
        bound = {torch.float64: DOUBLE_RTOL, torch.float32: FLOAT_RTOL["B2"]}
        for dtype, errs in errors.items():
            # d_matrix sums N products; in float that sum carries ~sqrt(N) ulps.
            limits = (bound[dtype], bound[dtype], 10 * bound[dtype])
            if any(e > lim for e, lim in zip(errs, limits)):
                raise AssertionError(f"B2 exceeds its bounds ({dtype}): {label}: {errs}")
        print(f"B2 check {label}: double out/d_particles/d_matrix"
              f" {'/'.join(f'{e:.2e}' for e in errors[torch.float64])};"
              f" float vs double {'/'.join(f'{e:.2e}' for e in errors[torch.float32])}")
    return worst_abs


@contextlib.contextmanager
def plain_on_cuda_guard(torch, ft):
    """Count calls of the kernels' plain versions with a CUDA tensor among
    their arguments while the block runs: ``count`` outside, ``backward``
    inside the particle moment sweep's backward (``_moment_sweep_vjp``, the
    JAX package's design: autograd of the plain walk)."""
    names = ("_table_reference_sweep", "_reference_sweep_vjp", "particle_apply_reference",
             "_moment_sweep_reference", "packed_gram_reference")
    originals = {name: getattr(ft, name) for name in (*names, "_moment_sweep_vjp")}
    hits = {"count": 0, "backward": 0}
    in_backward = [False]

    def on_cuda(value):
        if isinstance(value, torch.Tensor):
            return value.is_cuda
        if isinstance(value, (list, tuple)):
            return any(on_cuda(v) for v in value)
        return False

    def guarded(function):
        def wrapper(*args, **kwargs):
            if on_cuda(args):
                hits["backward" if in_backward[0] else "count"] += 1
            return function(*args, **kwargs)
        return wrapper

    def backward_walk(*args, **kwargs):
        in_backward[0] = True
        try:
            return originals["_moment_sweep_vjp"](*args, **kwargs)
        finally:
            in_backward[0] = False

    for name in names:
        setattr(ft, name, guarded(originals[name]))
    ft._moment_sweep_vjp = backward_walk
    try:
        yield hits
    finally:
        for name, function in originals.items():
            setattr(ft, name, function)


def reset_counts(ft, hist):
    for wrapper in (hist.window_histogram, ft.particle_apply, ft.moment_sweep, ft.moment_sweep_bwd,
                    ft.particle_moment_sweep, ft.packed_gram):
        wrapper.launches = 0


def counts(ft):
    return {"B2": ft.particle_apply.launches, "B3": ft.moment_sweep.launches,
            "B4": ft.moment_sweep_bwd.launches, "B5": ft.particle_moment_sweep.launches,
            "B6": ft.packed_gram.launches}


def sweep_params(torch, envs, B, device, seed):
    """Per-setting targets and incoming beams for B instances."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(low, high, *shape):
        return low + (high - low) * torch.rand(shape, generator=gen, device=device)

    target = torch.stack([u(-2e-3, 2e-3, B), u(1e-5, 1e-3, B), u(-2e-3, 2e-3, B),
                          u(1e-5, 1e-3, B)], dim=-1)
    sigma = torch.tensor([1.75e-4, 2e-5, 1.75e-4, 2e-5], device=device).expand(B, 4)
    return envs.EnvParams(target=target, incoming_mu=u(-1e-4, 1e-4, B, 4), incoming_sigma=sigma)


def path_serving(torch, ft, hist, envs, env, card):
    """Path S: batched_reset and SWEEP_STEPS batched_steps at SWEEP_BATCH
    settings (float) through B3; observations held against the CPU path."""
    B = SWEEP_BATCH
    params = sweep_params(torch, envs, B, "cuda", seed=21)
    gen = torch.Generator(device="cuda").manual_seed(22)
    actions = [torch.rand((B, 5), generator=gen, device="cuda") * 2 - 1 for _ in range(SWEEP_STEPS)]
    actions[0][0] = 0.0  # one zero setting, as the bench's zero sweep
    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        obs0, states = env.batched_reset(gen, params)
        observations = [obs0]
        for action in actions:
            obs, states, rewards, dones = env.batched_step(states, action, params)
            observations.append(obs)
        torch.cuda.synchronize()
    launched = counts(ft)  # the path's own launches, before any timing
    print(f"path S: {SWEEP_STEPS} batched_steps + reset at B={B}: launches {launched},"
          f" plain versions on CUDA tensors {plain['count']}")
    if launched["B3"] != SWEEP_STEPS + 1 or plain["count"] != 0:
        raise AssertionError("path S did not run every sweep through kernel B3")
    for obs in observations:
        if obs.shape != (B, 13) or not bool(torch.isfinite(obs).all()):
            raise AssertionError(f"path S: bad observation {tuple(obs.shape)}")
    if not bool((rewards <= 0).all()) or int(states.step_count[0]) != SWEEP_STEPS:
        raise AssertionError("path S: bad rewards or step counts")

    env_cpu = envs.make_env(device="cpu")
    params_cpu = envs.EnvParams(*(x.cpu() for x in params[:3]))
    worst = 0.0
    for obs in (observations[0], observations[-1]):
        expected = env_cpu.batched_beam_parameters(obs[:, :5].cpu(), params_cpu) * 1e3
        got = obs[:, 5:9].cpu()
        error = float(((got - expected).abs() / expected.abs().amax(dim=0)).max())
        worst = max(worst, error)
    print(f"path S: observations against the CPU dense route, max error {worst:.2e}"
          f" of each column's largest |value| (bound {OBS_RTOL})")
    if worst > OBS_RTOL:
        raise AssertionError("path S: GPU and CPU observations disagree")

    state0 = states

    def step():
        env.batched_step(state0, actions[1], params)

    ms = cuda_ms(step, iters=20)
    device, sweep = device_ms(step, iters=5, kernel="moment_sweep_kernel")
    print(f"path S: batched_step at B={B}: {ms:.4f} ms/step, {B * 1000.0 / ms:.1f} env-steps/s"
          f" (CUDA events, 20 steps after warm-up); device time {device:.4f} ms/step (busy"
          f" share {device / ms:.4f}), of it B3 {sweep:.4f} ms (torch.profiler, 5 steps;"
          f" card {card})")
    return launched


def path_training(torch, ft, hist, envs, env, tuning, card):
    """Path T: tuning.tune's eager loop (``graph=False``; path J3 holds the
    graphed tuner to it) of (SWEEP_BATCH, 5) settings for SWEEP_STEPS
    Adam steps through B3 and B4; the loss must fall, and the first step's
    gradient is held against autograd of the plain version in double."""
    B = SWEEP_BATCH
    params = sweep_params(torch, envs, B, "cuda", seed=31)
    gen = torch.Generator(device="cuda").manual_seed(32)
    start = torch.rand((B, 5), generator=gen, device="cuda") - 0.5

    def loss_fn(magnets, params):
        observed = env.batched_beam_parameters(magnets, params)
        return torch.mean(torch.abs(observed - params.target))

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:  # the eager loop: path J3 graphs it
        tuned, losses = tuning.tune(loss_fn, start, params, steps=SWEEP_STEPS, graph=False)
        torch.cuda.synchronize()
    launched = counts(ft)  # the path's own launches, before any timing
    losses = losses.tolist()
    print(f"path T: tune of ({B}, 5) settings, {SWEEP_STEPS} Adam steps (the eager loop): loss"
          f" {losses[0]:.6e}"
          f" -> {losses[-1]:.6e}; launches {launched}, plain versions on CUDA tensors"
          f" {plain['count']}")
    if launched["B3"] != SWEEP_STEPS or launched["B4"] != SWEEP_STEPS or plain["count"]:
        raise AssertionError("path T did not run every step through kernels B3 and B4")
    if not losses[-1] < losses[0] or not bool(torch.isfinite(tuned).all()):
        raise AssertionError("path T: the loss did not fall")

    magnets = start.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss_fn(magnets, params), magnets)
    env64 = envs.make_env(dtype=torch.float64, device="cuda")
    params64 = envs.EnvParams(*(x.double() for x in params[:3]))

    def plain_sweep(entries, energy, mu, cov, *values):
        return ft._table_reference_sweep(entries, [v.to(mu.dtype) for v in values], energy, mu, cov)

    function = ft._FusedMomentSweep
    ft._FusedMomentSweep = type("PlainSweep", (), {"apply": staticmethod(plain_sweep)})
    try:
        magnets64 = start.double().requires_grad_(True)
        observed = env64.batched_beam_parameters(magnets64, params64)
        (grad64,) = torch.autograd.grad(
            torch.mean(torch.abs(observed - params64.target)), magnets64
        )
    finally:
        ft._FusedMomentSweep = function
    # Settings with a quadrupole near k1 = 0 are held only to finite values
    # (see K1_SMALL).
    small = (start[:, :3] * env._limits[:3]).abs().lt(K1_SMALL).any(dim=1)
    keep = ~small
    error = float(
        ((grad.double() - grad64).abs()[keep] / grad64[keep].abs().amax(dim=0)).max()
    )
    print(f"path T: first-step gradient (B3/B4, float) against autograd of the plain version"
          f" (double): max error {error:.2e} of each column's largest |value| (bound {GRAD_RTOL};"
          f" {int(small.sum())} settings with |k1| < {K1_SMALL} held to finite values)")
    if error > GRAD_RTOL or not bool(torch.isfinite(grad).all()):
        raise AssertionError("path T: the kernels' gradient disagrees with the plain version's")

    def step():
        m = start.clone().requires_grad_(True)
        loss_fn(m, params).backward()

    ms = cuda_ms(step, iters=10)
    device, backward = device_ms(step, iters=3, kernel="moment_sweep_bwd_kernel")
    print(f"path T: value and gradient at B={B}: {ms:.4f} ms/step (CUDA events, 10 steps after"
          f" warm-up); device time {device:.4f} ms/step (busy share {device / ms:.4f}), of it"
          f" B4 {backward:.4f} ms (torch.profiler, 3 steps; card {card})")
    return launched


def push_path_beam(torch, ares, ParticleBeam, B, N, seed):
    segment = ares.ares_ea_segment(device="cuda").broadcast((B,))
    segment.AREABSCR1.is_active = False
    spread = torch.linspace(0.8, 1.2, B, device="cuda")
    k1 = {name: (value * spread).requires_grad_(True) for name, value in ares.FLAGSHIP_K1.items()}
    for name, value in k1.items():
        getattr(segment, name).k1 = value
    shape = (B,)
    beam = ParticleBeam.from_parameters(
        num_particles=N,
        sigma_x=torch.full(shape, 1.75e-4), sigma_y=torch.full(shape, 1.75e-4),
        sigma_xp=torch.full(shape, 2e-5), sigma_yp=torch.full(shape, 2e-5),
        sigma_s=torch.full(shape, 8e-6), sigma_p=torch.full(shape, 2e-3),
        energy=torch.full(shape, 1.073e8),
        generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda",
    )
    return segment, beam, k1


def path_particles(torch, ft, hist, segment_module, ares, ParticleBeam, card):
    """Path P: Segment.track of PUSH_BATCH settings x PUSH_PARTICLES
    particles through B2, with the gradient of a moment loss with respect
    to the three k1; held against the dense route; pushes/s of both routes
    at a few N for the crossover."""
    B, N = PUSH_BATCH, PUSH_PARTICLES
    segment, beam, k1 = push_path_beam(torch, ares, ParticleBeam, B, N, seed=41)

    def moment_loss(outgoing):
        return torch.mean(outgoing.sigma_x**2 + outgoing.sigma_y**2)

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        outgoing = segment.track(beam)
        grads = torch.autograd.grad(moment_loss(outgoing), list(k1.values()))
        torch.cuda.synchronize()
    launched = counts(ft)  # the path's own launches, before any timing
    print(f"path P: Segment.track of {B} x {N} particles and d(loss)/dk1: launches {launched},"
          f" plain versions on CUDA tensors {plain['count']}")
    if launched["B2"] != 2 or plain["count"]:
        raise AssertionError("path P did not push and back-propagate through kernel B2")
    if outgoing.particles.shape != (B, N, 7) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("path P: bad output or gradient")

    segment_module.PARTICLE_SWEEP_PATH = False
    try:
        dense = segment.track(beam)
        dense_grads = torch.autograd.grad(moment_loss(dense), list(k1.values()))
    finally:
        segment_module.PARTICLE_SWEEP_PATH = None
    push_error = relative_error(torch, outgoing.particles.detach(), dense.particles.detach())
    grad_error = max(relative_error(torch, g, d, per_setting=False)
                     for g, d in zip(grads, dense_grads))
    print(f"path P: against the dense route: particles {push_error:.2e} per setting,"
          f" d/dk1 {grad_error:.2e} (bounds {FLOAT_RTOL['B2']}, {GRAD_RTOL})")
    if push_error > FLOAT_RTOL["B2"] or grad_error > GRAD_RTOL:
        raise AssertionError("path P: the B2 route and the dense route disagree")

    for b, n in ((B, 1_000), (B, N), (32, 100_000)):
        seg_b, beam_b, k1_b = push_path_beam(torch, ares, ParticleBeam, b, n, seed=42)
        for route in (True, False):
            segment_module.PARTICLE_SWEEP_PATH = route
            try:
                forward = cuda_ms(lambda: seg_b.track(beam_b), iters=20)

                def both():
                    out = seg_b.track(beam_b)
                    torch.autograd.grad(moment_loss(out), list(k1_b.values()))

                backward = cuda_ms(both, iters=10)
                device, push = device_ms(
                    lambda: seg_b.track(beam_b), iters=5,
                    kernel="particle_apply_kernel" if route else "gemm",
                )
            finally:
                segment_module.PARTICLE_SWEEP_PATH = None
            name = "B2" if route else "dense"
            print(f"path P: {name} route at B={b}, N={n}: track {forward:.4f} ms"
                  f" ({b * n * 1000.0 / forward:.4e} pushes/s), track + gradient {backward:.4f} ms"
                  f" ({b * n * 1000.0 / backward:.4e} pushes/s) (CUDA events); device time of"
                  f" the track {device:.4f} ms, of it the push ({'B2' if route else 'gemm'})"
                  f" {push:.4f} ms (torch.profiler, 5 calls; card {card})")
    return launched


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` (each input read once, each output written once) and to do
    ``flops`` of float32 arithmetic, at HBM_BYTES_PER_S and
    FP32_FLOPS_PER_S."""
    memory_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    compute_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (memory_ms, "bytes") if memory_ms >= compute_ms else (compute_ms, "operations")


# Structural supports of 7x7 maps, as masks: bit 7 i + j is cell (i, j).
# A support holds the cells that may be non-zero, its ones the cells that
# are exactly 1.
def mask_of(pairs):
    return sum(1 << (7 * i + j) for i, j in pairs)


IDENTITY = mask_of((i, i) for i in range(7))
DENSE = (1 << 49) - 1
COLUMN = mask_of((j, 0) for j in range(7))  # a vector, as a map's first column


def has(mask, i, j):
    return mask >> (7 * i + j) & 1


def transposed(mask):
    return mask_of((j, i) for i in range(7) for j in range(7) if has(mask, i, j))


def product(a, a_ones, b, b_ones):
    """(support, ones, flops) of A @ B for supports a, b with ones a_ones,
    b_ones: per output cell, the terms whose factors may both be non-zero,
    a multiply for each term without a structural one and an add between
    terms (fused_builders.cuh's product_support and product_ones)."""
    support = ones = flops = 0
    for i in range(7):
        for k in range(7):
            terms = [j for j in range(7) if has(a, i, j) and has(b, j, k)]
            if not terms:
                continue
            plain = [j for j in terms if not (has(a_ones, i, j) or has(b_ones, j, k))]
            flops += len(plain) + len(terms) - 1
            support |= 1 << (7 * i + k)
            j = terms[0]
            if len(terms) == 1 and has(a_ones, i, j) and has(b_ones, j, k):
                ones |= 1 << (7 * i + k)
    return support, ones, flops


def dynamic_support(ft, code):
    """Support and ones of a dynamic tape entry's map (fused_builders.cuh's
    builders): a drift or an undulator, a corrector (a drift and its kick
    cell), a quadrupole (exit @ rot(-tilt) @ base @ rot(tilt) @ entry), an
    inactive cavity (its 12 cells), a solenoid (exit @ body @ entry), a
    dipole (rot(-tilt) @ edge @ body @ edge @ rot(tilt)), or a custom map
    (dense)."""
    drift = IDENTITY | mask_of([(0, 1), (2, 3), (4, 5)])
    if code in (ft.TAPE_DRIFT, ft.TAPE_UNDULATOR):
        return drift, IDENTITY
    if code in (ft.TAPE_HCOR, ft.TAPE_VCOR):
        return drift | mask_of([(1, 6) if code == ft.TAPE_HCOR else (3, 6)]), IDENTITY
    if code == ft.TAPE_CUSTOM:
        return DENSE, 0
    tail = mask_of([(4, 4), (5, 5), (6, 6)])
    shift = IDENTITY | mask_of([(0, 6), (2, 6)])
    if code == ft.TAPE_CAVITY:
        return mask_of([(0, 0), (0, 1), (1, 0), (1, 1), (2, 2), (2, 3), (3, 2), (3, 3), (4, 4),
                        (4, 5), (5, 4), (5, 5), (6, 6)]), mask_of([(6, 6)])
    if code == ft.TAPE_SOLENOID:
        body = IDENTITY | mask_of([(i, j) for i in range(4) for j in range(4)] + [(4, 5)])
        s, o, _ = product(body, tail, shift, IDENTITY)
        s, o, _ = product(shift, IDENTITY, s, o)
        return s, o
    base = IDENTITY | mask_of(
        [(0, 1), (0, 5), (1, 0), (1, 5), (2, 3), (3, 2), (4, 0), (4, 1), (4, 5)])
    rot = IDENTITY | mask_of([(0, 2), (1, 3), (2, 0), (3, 1)])
    if code == ft.TAPE_DIPOLE:
        edge = IDENTITY | mask_of([(1, 0), (3, 2)])
        s, o, _ = product(base | mask_of([(2, 6)]), tail, edge, IDENTITY)
        s, o, _ = product(edge, IDENTITY, s, o)
        s, o, _ = product(s, o, rot, tail)
        s, o, _ = product(rot, tail, s, o)
        return s, o
    assert code == ft.TAPE_QUAD, code
    s, o, _ = product(base, tail, rot, tail)
    s, o, _ = product(rot, tail, s, o)
    s, o, _ = product(s, o, shift, IDENTITY)
    s, o, _ = product(shift, IDENTITY, s, o)
    return s, o


def sweep_flops(ft, entries):
    """Flops per setting that B3 and B4 need on one plan, counted on the
    structural supports of its maps (dynamic: the builders'; const: the
    cells that are not literal zeros), with dense moments and cotangents.
    B3: the chain T = R_{E-1} .. R_0, T mu and T C T^T.  B4: the chain; T^T
    dmu and T^T dcov T; dT = dmu mu^T + dcov T C^T + dcov^T T C; per entry
    in reverse, the cells of dR_i = A M_i^T that its inputs reach, their
    contraction with dR_i/dp for each dynamic input, and A <- R_i^T A; the
    batch sum of the const cells' cotangents.  The builders' own arithmetic
    is not counted."""
    maps = []  # (support, ones, cells of dR, dynamic inputs) per entry
    for kind, meta, count in entries:
        if kind == "dyn":
            code = meta.tape_kind
            if code == ft.TAPE_IDENTITY:
                continue
            support, ones = dynamic_support(ft, code)
            # A custom map's cells are its inputs: their cotangents are dR's.
            inputs = 0 if code == ft.TAPE_CUSTOM else count + 1
            maps.append((support, ones, support & ~ones, inputs))
        else:
            literal = [[isinstance(c, float) for c in row] for row in meta]
            support = mask_of((i, j) for i in range(7) for j in range(7)
                            if not (literal[i][j] and meta[i][j] == 0.0))
            ones = mask_of((i, j) for i in range(7) for j in range(7)
                         if literal[i][j] and meta[i][j] == 1.0)
            free = mask_of((i, j) for i in range(7) for j in range(7) if not literal[i][j])
            maps.append((support, ones, free, 0))
    chain, prefixes = 0, []
    m, m_ones = IDENTITY, IDENTITY
    for support, ones, _, _ in maps:
        prefixes.append((m, m_ones))
        m, m_ones, flops = product(support, ones, m, m_ones)
        chain += flops
    t, t_ones = m, m_ones
    tt, tt_ones = transposed(t), transposed(t_ones)
    tc, _, tc_flops = product(t, t_ones, DENSE, 0)  # T C, and T C^T alike
    b3 = chain + product(t, t_ones, COLUMN, 0)[2] + tc_flops + product(tc, 0, tt, tt_ones)[2]
    x, _, x_flops = product(DENSE, 0, t, t_ones)  # dcov T
    b4 = (chain + product(tt, tt_ones, COLUMN, 0)[2] + x_flops + product(tt, tt_ones, x, 0)[2]
          + 2 * tc_flops + 2 * product(DENSE, 0, tc, 0)[2] + 49 + 2 * 49)
    for e in reversed(range(len(maps))):
        support, ones, reached, inputs = maps[e]
        m, m_ones = prefixes[e]
        for c in range(7):  # dR_i[r, c] = sum_k A[r, k] M_i[c, k], A dense
            row = [k for k in range(7) if has(m, c, k)]
            plain = [k for k in row if not has(m_ones, c, k)]
            n_cells = sum(has(reached, r, c) for r in range(7))
            b4 += n_cells * (len(plain) + len(row) - 1)
        n = bin(reached).count("1")
        b4 += inputs * (2 * n - 1) if inputs else n  # contractions, or the batch sum
        if e:
            b4 += product(transposed(support), transposed(ones), DENSE, 0)[2]
    return b3, b4


def sweep_bounds(ft, entries, values, full, mu, cov):
    """Bounds of B3 and B4 on one plan: their operands as the wrappers pass
    them, and the flops of :func:`sweep_flops`."""
    B = mu.shape[0]
    tape = ft._tape(entries, mu.device)
    params, consts = ft._tape_operands(entries, values, tape, mu.dtype, B)
    b3_flops, b4_flops = sweep_flops(ft, entries)
    b3 = bound(nbytes(params, consts, full, mu, cov) + nbytes(mu, cov), B * b3_flops)
    d_consts = tape.cell_pos.shape[0] * B * mu.element_size()
    b4 = bound(nbytes(params, consts, full, mu, cov, mu, cov)
               + nbytes(params, full, mu, cov) + d_consts, B * b4_flops)
    return b3, b4


def time_kernels(torch, ft, fused, tbl, env, card):
    """Kernel and plain times at the paths' shapes, float, CUDA events; the
    bounds; for B2, torch.bmm of the same operands as the yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    magnets = torch.rand((SWEEP_BATCH, 5), generator=gen, device="cuda") * 2 - 1
    tuned = env._batched_tuned_segment(magnets)
    energy = torch.tensor([1.073e8], device="cuda")
    plan = fused.plan_run(
        [fused.element_map_builder(el) for el in tuned.flattened().elements], energy,
        lambda x: torch.broadcast_to(x, (SWEEP_BATCH,)).reshape(SWEEP_BATCH),
    )
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v.detach() for _, _, vs in plan for v in vs]
    mu, cov = (t.float() for t in random_moments(torch, SWEEP_BATCH, gen))
    full = energy.expand(SWEEP_BATCH).contiguous()
    dmu, dcov = torch.randn_like(mu), torch.randn_like(cov)
    args = (entries, values, full, mu, cov)
    b3_bound, b4_bound = sweep_bounds(ft, entries, [v.float() for v in values], full, mu, cov)
    shape = f"B={SWEEP_BATCH}, {len(entries)} entries"
    timing = {
        "B3": dict(ms=cuda_ms(lambda: ft.moment_sweep(*args), iters=50),
                   plain_ms=cuda_ms(lambda: ft._table_reference_sweep(*args), iters=10),
                   bound=b3_bound, library_ms=None, shape=shape),
        "B4": dict(ms=cuda_ms(lambda: ft.moment_sweep_bwd(*args, dmu, dcov), iters=50),
                   plain_ms=cuda_ms(lambda: ft._reference_sweep_vjp(*args, dmu, dcov),
                                      iters=10),
                   bound=b4_bound, library_ms=None, shape=shape),
    }
    calls = {
        "B3": (lambda: ft.moment_sweep(*args), lambda: ft._table_reference_sweep(*args),
               "moment_sweep_kernel"),
        "B4": (lambda: ft.moment_sweep_bwd(*args, dmu, dcov),
               lambda: ft._reference_sweep_vjp(*args, dmu, dcov), "moment_sweep_bwd_kernel"),
    }
    # B2 at path P's shape (the JSON line's) and at the crossover's largest
    # N; the library call is one batched product of the same float operands
    # (TF32 off, phase 1).
    for label, (B, N) in (("B2", (PUSH_BATCH, PUSH_PARTICLES)), ("B2, N=100,000", (32, 100_000))):
        layout, matrix, particles = push_inputs(torch, fused, tbl, ft, B, N, seed=52)
        matrix, particles = matrix.float(), particles.float()
        maps = matrix.view(B, 7, 7).transpose(1, 2)
        zeros, _ = ft._layout_masks(layout)
        cells = 49 - bin(zeros).count("1")

        def kernel(layout=layout, matrix=matrix, particles=particles):
            return ft.particle_apply(layout, matrix, particles)

        def plain(layout=layout, matrix=matrix, particles=particles):
            return ft.particle_apply_reference(layout, matrix, particles)

        def library(particles=particles, maps=maps):
            return torch.bmm(particles, maps)

        timing[label] = dict(
            ms=cuda_ms(kernel, iters=100), plain_ms=cuda_ms(plain, iters=20),
            bound=bound(nbytes(matrix, particles, particles), 2 * cells * B * N),
            library_ms=cuda_ms(library, iters=100), shape=f"B={B}, N={N}",
        )
        calls[label] = (kernel, plain, "particle_apply_kernel", library)
    for name, t in timing.items():
        kernel_call, plain_call, kernel_name, *library_call = calls[name]
        device, own = device_ms(kernel_call, iters=5, kernel=kernel_name)
        plain_device = device_ms(plain_call, iters=2)
        library = ""
        if library_call:
            library_device = device_ms(library_call[0], iters=5)
            library = (f"; library call torch.bmm {t['library_ms']:.5f} ms per call, device"
                       f" {library_device:.5f} ms")
        print(f"{name} at {t['shape']} (float): kernel {t['ms']:.5f} ms, plain"
              f" {t['plain_ms']:.4f} ms per call (CUDA events, host launch cost included); device"
              f" time per call: kernel {own:.5f} ms, all of the wrapper's GPU work"
              f" {device:.5f} ms, plain {plain_device:.5f} ms (torch.profiler){library}; bound"
              f" {t['bound'][0]:.5f} ms ({t['bound'][1]}); card {card}")
    return timing


# -- the particle moment sweep: kernels B5 and B6 -------------------------------


def sum_errors(torch, actual, expected):
    """(first, second, max |weight change|) of moment sums ``(s1, s2, w)``
    against the plain version's, on the bounds' scales (MOMENT_DOUBLE_RTOL)."""
    s1, s2, w = (t.detach().double() for t in actual)
    e1, e2, ew = (t.detach().double() for t in expected)
    scale2 = e2.abs().amax(dim=(1, 2)).clamp_min(1e-300)
    diag = e2.diagonal(dim1=1, dim2=2).abs().amax(dim=1)
    scale1 = (ew.clamp_min(1.0) * diag).sqrt().clamp_min(1e-300)
    first = float(((s1 - e1).abs().amax(dim=1) / scale1).max())
    second = float(((s2 - e2).abs().amax(dim=(1, 2)) / scale2).max())
    return first, second, float((w - ew).abs().max())


def gram_sums(gram):
    """A (B, 8, 8) joint Gram as the sums (s1, s2, w) of the augmented cloud."""
    return gram[:, 7, :7], gram[:, :7, :7], gram[:, 7, 7]


def aperture_lattice(torch, ltt, B, variant, dtype, k1=None):
    """benchmarks/aperture_sweep_ab.py's lattice on the card: Drift 0.3 m,
    Quadrupole 0.12 m with k1 = linspace(-8, 8, B), the ``variant``'s
    apertures, Drift 0.4 m, Quadrupole 0.12 m with k1 = 3, Drift 0.2 m.
    Variants: "rect" (the benchmark's 3e-4 x 4e-4 m rectangle), "two"
    (a rectangle with x_max = inf, a drift, an ellipse), "lost" (the
    rectangle with one setting closed to 1e-9 m), "none"."""
    kw = dict(dtype=dtype, device="cuda")

    def t(*values):
        return torch.tensor(values, **kw)

    if k1 is None:
        k1 = torch.linspace(-8.0, 8.0, B, **kw)
    apertures = {
        "rect": [ltt.Aperture(x_max=t(3e-4), y_max=t(4e-4), **kw)],
        "two": [ltt.Aperture(x_max=t(float("inf")), y_max=t(4e-4), **kw),
                ltt.Drift(t(0.1), **kw),
                ltt.Aperture(x_max=t(3e-4), y_max=t(5e-4), shape="elliptical", **kw)],
        "lost": [ltt.Aperture(x_max=torch.where(torch.arange(B, device="cuda") == 1, 1e-9, 3e-4)
                              .to(dtype), y_max=t(4e-4), **kw)],
        "none": [],
    }[variant]
    return [ltt.Drift(t(0.3), **kw), ltt.Quadrupole(t(0.12), k1=k1, **kw), *apertures,
            ltt.Drift(t(0.4), **kw), ltt.Quadrupole(t(0.12), k1=torch.full((B,), 3.0, **kw), **kw),
            ltt.Drift(t(0.2), **kw)]


def moment_cloud(torch, ParticleBeam, n, seed, dtype=None):
    """The shared cloud of paths K and A (the JAX bench's beam: sigma_x =
    sigma_y = 175 um, the other widths at their defaults, E = 107.3 MeV),
    float32 unless ``dtype`` says otherwise."""
    dtype = torch.float32 if dtype is None else dtype
    return ParticleBeam.from_parameters(
        num_particles=n, sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        energy=torch.tensor([1.073e8]), generator=torch.Generator(device="cuda").manual_seed(seed),
        dtype=dtype, device="cuda",
    )


def plan_of(torch, fused, elements, B, dtype):
    return fused.particle_moment_plan(
        elements, torch.tensor(1.073e8, dtype=dtype, device="cuda"),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )


def kernel_operands(torch, ft, fused, elements, B, particles):
    """What sweep_particle_moments hands the kernels for this lattice: the
    6-field entries, the scalars, the deviation cloud and its weights."""
    entries, scalars = plan_of(torch, fused, elements, B, particles.dtype)
    weights = torch.ones(particles.shape[0], dtype=particles.dtype, device="cuda")
    kernel_entries, extra, delta, _ = ft._centered_plan(entries, scalars, particles, weights)
    return kernel_entries, extra, delta, weights


def check_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam):
    """Phase 3: B5 and B6 against their plain versions on the card, double
    and float.  Returns each kernel's max |error| in float at its path's
    shape (B5: path K at B = 8; B6: path A at B = 256)."""
    cloud = moment_cloud(torch, ParticleBeam, ODD_PARTICLES, seed=71, dtype=torch.float64).particles[0]
    gen = torch.Generator(device="cuda").manual_seed(72)
    cases = []  # (label, kernel, B, elements, particles)
    for kernel, B in (("B5", 13), ("B6", 17), ("B6", 33)):
        for variant in ("rect", "two", "lost"):
            cases.append((f"{variant}, B={B}", kernel, B,
                          aperture_lattice(torch, ltt, B, variant, torch.float64), ODD_PARTICLES))
    # B5 at the route's edges (B = 1 and 15), on a cloud smaller than one
    # block's span of particles, and on no particle at all.
    for B, n in ((1, ODD_PARTICLES), (15, ODD_PARTICLES), (5, SMALL_CLOUD), (4, 0)):
        cases.append((f"two, B={B}", "B5", B, aperture_lattice(torch, ltt, B, "two", torch.float64),
                      n))
    for kernel, B in (("B5", 8), ("B6", 256)):
        magnets = torch.rand((B, 5), generator=gen, device="cuda") - 0.5
        cases.append((f"path K plan (no aperture), B={B}", kernel, B,
                      list(env._batched_tuned_segment(magnets).flattened().elements),
                      ODD_PARTICLES))
    cases.append(("path A plan, B=256", "B6", 256,
                  aperture_lattice(torch, ltt, 256, "rect", torch.float64), ODD_PARTICLES))
    worst_abs = {}
    for label, kernel, B, elements, n in cases:
        ops64 = kernel_operands(torch, ft, fused, elements, B, cloud[:n])
        ops32 = (ops64[0], tuple(v.float() for v in ops64[1]), ops64[2].float(), ops64[3].float())
        rounded = (ops32[0], tuple(v.double() for v in ops32[1]), ops32[2].double(),
                   ops32[3].double())
        if kernel == "B5":
            def run(ops):
                return ft.particle_moment_sweep(*ops)

            def plain(ops):
                return ft._moment_sweep_reference(*ops)
        else:
            def run(ops):
                return gram_sums(ft.packed_gram(*ft._packed_operands(*ops)[0]))

            def plain(ops):
                return gram_sums(ft.packed_gram_reference(*ft._packed_operands(*ops)[0]))
        expected = plain(ops64)
        double = sum_errors(torch, run(ops64), expected)
        single_out = run(ops32)
        single_ref = plain(rounded)
        single = sum_errors(torch, single_out, single_ref)
        torch.cuda.synchronize()
        survivors = expected[2]
        print(f"{kernel} check {label}, N={n}: double first/second {double[0]:.2e}/"
              f"{double[1]:.2e}, |dW| {double[2]:.0f}; float vs double first/second"
              f" {single[0]:.2e}/{single[1]:.2e}, net flipped particles per setting <="
              f" {single[2]:.0f}; survivors {survivors.min().item():.0f}-{survivors.max().item():.0f}")
        if max(double[:2]) > MOMENT_DOUBLE_RTOL or double[2] != 0:
            raise AssertionError(f"{kernel} in double exceeds {MOMENT_DOUBLE_RTOL}: {label}")
        if max(single[:2]) > MOMENT_FLOAT_RTOL or single[2] > MAX_FLIPS:
            raise AssertionError(f"{kernel} in float exceeds its bounds: {label}")
        if n == 0:
            if any(bool((t != 0).any()) for t in run(ops64) + single_out):
                raise AssertionError(f"{kernel}: sums of no particle are not 0: {label}")
        elif ("lost" in label) != bool((survivors == 0).any()):
            raise AssertionError(f"{kernel}: the all-lost setting is wrong: {label}")
        if label in ("path K plan (no aperture), B=8", "path A plan, B=256"):
            worst_abs[kernel] = max(float((a.double() - e).abs().max())
                                    for a, e in zip(single_out, single_ref))

    # An identity-only plan takes its settings axis from batch_size=.
    identity = (("map", tuple(tuple(1.0 if i == j else 0.0 for j in range(7)) for i in range(7))),)
    weights = torch.ones(cloud.shape[0], dtype=torch.float64, device="cuda")
    expected = ft._moment_sweep_reference(identity, (torch.zeros(9, dtype=torch.float64,
                                                                  device="cuda"),), cloud, weights)
    for packed in (False, True):
        ft.PACKED_MOMENT_SWEEP = packed
        try:
            actual = ft.fused_particle_moment_sweep(identity, (), cloud, weights, batch_size=9)
        finally:
            ft.PACKED_MOMENT_SWEEP = None
        errors = sum_errors(torch, actual, expected)
        print(f"{'B6' if packed else 'B5'} check identity-only plan with batch_size=9: double"
              f" first/second {errors[0]:.2e}/{errors[1]:.2e}, |dW| {errors[2]:.0f}")
        if max(errors[:2]) > MOMENT_DOUBLE_RTOL or errors[2] != 0 or actual[0].shape != (9, 7):
            raise AssertionError("the identity-only plan disagrees with the plain walk")
    return worst_abs


def column_error(torch, actual, expected):
    """Max error of each column relative to its largest |expected| value."""
    return float(((actual.double() - expected.double()).abs()
                  / expected.double().abs().amax(dim=0).clamp_min(1e-300)).max())


def path_env_kernel(torch, ft, hist, env, ParticleBeam, card):
    """Path K: the env's particle-fidelity observation, method="kernel",
    with one shared MOMENT_PARTICLES cloud, at B = 256 (B6) and 8 (B5);
    held against method="moments"; env-steps/s of the three methods at
    B = 256."""
    beam = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=81)
    gen = torch.Generator(device="cuda").manual_seed(82)
    launched = {}
    for B in ENV_KERNEL_BATCHES:
        magnets = torch.rand((B, 5), generator=gen, device="cuda") - 0.5
        reset_counts(ft, hist)
        with plain_on_cuda_guard(torch, ft) as plain:
            kernel = env.batched_particle_beam_parameters(magnets, beam, method="kernel")
            torch.cuda.synchronize()
        launched[B] = counts(ft)
        route = "B6" if B >= ft._PACK_SETTINGS else "B5"
        other = "B5" if route == "B6" else "B6"
        print(f"path K: method='kernel' at B={B}, N={MOMENT_PARTICLES}: launches {launched[B]},"
              f" plain versions on CUDA tensors {plain['count']}")
        if launched[B][route] != 1 or launched[B][other] != 0 or plain["count"] or plain["backward"]:
            raise AssertionError(f"path K at B={B} did not go through kernel {route}")
        moments = env.batched_particle_beam_parameters(magnets, beam, method="moments")
        error = column_error(torch, kernel, moments)
        print(f"path K: B={B} kernel against method='moments', max error {error:.2e} of each"
              f" column's largest |value| (bound {KERNEL_OBS_RTOL})")
        if kernel.shape != (B, 4) or not bool(torch.isfinite(kernel).all()) or error > KERNEL_OBS_RTOL:
            raise AssertionError(f"path K at B={B}: method='kernel' disagrees with 'moments'")

    B = ENV_KERNEL_BATCHES[0]
    magnets = torch.rand((B, 5), generator=gen, device="cuda") - 0.5
    rates = {}
    for method, iters in (("kernel", 20), ("moments", 20), ("particles", 5)):
        def call():
            return env.batched_particle_beam_parameters(magnets, beam, method=method)

        ms = cuda_ms(call, iters=iters)
        rates[method] = B * 1000.0 / ms
        device = device_ms(call, iters=3)
        print(f"path K: method='{method}' at B={B}, N={MOMENT_PARTICLES}: {ms:.4f} ms/call,"
              f" {rates[method]:.1f} env-steps/s (CUDA events, {iters} calls after warm-up);"
              f" device time {device:.4f} ms/call, busy share {device / ms:.4f} (torch.profiler,"
              f" 3 calls; card {card})")
    return launched[ENV_KERNEL_BATCHES[1]]["B5"], launched[ENV_KERNEL_BATCHES[0]]["B6"]


def path_aperture_sweep(torch, ltt, ft, hist, fused, functional, ParticleBeam, card):
    """Path A: the aperture-interleaved sweep through particle_moment_plan
    and sweep_particle_moments at B = 32 and 256, float, with the gradient
    of sum(sigma_x) with respect to the first quadrupole's k1; held against
    dense functional.track and against autograd of the plain walk in
    double; settings/s of both routes."""
    beam = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=91)
    particles = beam.particles[0]
    weights = torch.ones(MOMENT_PARTICLES, device="cuda")
    b6_launches = 0
    for B in APERTURE_BATCHES:
        k1 = torch.linspace(-8.0, 8.0, B, device="cuda").requires_grad_(True)
        elements = aperture_lattice(torch, ltt, B, "rect", torch.float32, k1=k1)
        reset_counts(ft, hist)
        with plain_on_cuda_guard(torch, ft) as plain:
            entries, scalars = plan_of(torch, fused, elements, B, torch.float32)
            mu, cov, w_sum = ft.sweep_particle_moments(entries, scalars, particles, weights)
            sigma_x = cov[:, 0, 0].sqrt()
            (grad,) = torch.autograd.grad(sigma_x.sum(), k1)
            torch.cuda.synchronize()
        launched = counts(ft)
        b6_launches += launched["B6"]
        print(f"path A: sweep + d(sum sigma_x)/dk1 at B={B}, N={MOMENT_PARTICLES}: launches"
              f" {launched}, plain versions on CUDA tensors: forward {plain['count']}, backward"
              f" {plain['backward']} (autograd of the plain walk, the JAX package's design)")
        if launched["B6"] != 1 or launched["B5"] or plain["count"] or not plain["backward"]:
            raise AssertionError(f"path A at B={B} did not run its forward through kernel B6")

        with torch.no_grad():
            dense, _ = functional.track(ltt.Segment(elements), beam.broadcast((B,)))
        w_sum = w_sum.detach()
        flips = float((w_sum - dense.num_particles_survived).abs().max())
        errors = {}
        for stat, value, plane in (("mu_x", mu[:, 0], "sigma_x"), ("mu_y", mu[:, 2], "sigma_y"),
                                   ("sigma_x", sigma_x, "sigma_x"),
                                   ("sigma_y", cov[:, 2, 2].sqrt(), "sigma_y")):
            scale = float(getattr(dense, plane).abs().max())
            errors[stat] = float((value.detach() - getattr(dense, stat)).abs().max()) / scale
        print(f"path A: B={B} against dense functional.track: survivors"
              f" {int(w_sum.min())}-{int(w_sum.max())} of {MOMENT_PARTICLES}, net flipped"
              f" particles per setting <= {flips:.0f} (bound {MAX_FLIPS}); errors relative to the"
              f" plane's largest sigma: {', '.join(f'{k} {v:.2e}' for k, v in errors.items())}"
              f" (bound {APERTURE_RTOL})")
        if not 0 < float(w_sum.min()) < MOMENT_PARTICLES or flips > MAX_FLIPS:
            raise AssertionError(f"path A at B={B}: survivors disagree with dense tracking")
        if max(errors.values()) > APERTURE_RTOL:
            raise AssertionError(f"path A at B={B}: moments disagree with dense tracking")

        # The gradient against autograd of the plain walk in double.
        k1_64 = k1.detach().double().requires_grad_(True)
        elements64 = aperture_lattice(torch, ltt, B, "rect", torch.float64, k1=k1_64)
        route, ft.PARTICLE_MOMENT_SWEEP_PATH = ft.PARTICLE_MOMENT_SWEEP_PATH, False
        try:
            entries64, scalars64 = plan_of(torch, fused, elements64, B, torch.float64)
            _, cov64, _ = ft.sweep_particle_moments(entries64, scalars64, particles.double(),
                                                    weights.double())
            (grad64,) = torch.autograd.grad(cov64[:, 0, 0].sqrt().sum(), k1_64)
        finally:
            ft.PARTICLE_MOMENT_SWEEP_PATH = route
        small = k1.detach().abs() < K1_SMALL
        error = float((grad.double() - grad64).abs()[~small].max() / grad64.abs().max())
        print(f"path A: B={B} d(sum sigma_x)/dk1 (B6 forward, chunked backward, float) against"
              f" autograd of the plain walk (double): max error {error:.2e} of the largest"
              f" |value| (bound {GRAD_RTOL}; {int(small.sum())} settings with |k1| < {K1_SMALL}"
              f" held to finite values)")
        if error > GRAD_RTOL or not bool(torch.isfinite(grad).all()):
            raise AssertionError(f"path A at B={B}: the gradient disagrees with the plain walk's")

        def kernel_route():
            with torch.no_grad():
                entries, scalars = plan_of(torch, fused, elements, B, torch.float32)
                return ft.sweep_particle_moments(entries, scalars, particles, weights)

        def dense_route():
            with torch.no_grad():
                out, _ = functional.track(ltt.Segment(elements), beam.broadcast((B,)))
                return out.sigma_x, out.sigma_y, out.mu_x, out.mu_y

        kernel_ms = cuda_ms(kernel_route, iters=20)
        dense_ms = cuda_ms(dense_route, iters=5)
        kernel_device, gram_device = device_ms(kernel_route, iters=3,
                                                    kernel="packed_gram_kernel")
        dense_device = device_ms(dense_route, iters=3)
        print(f"path A: B={B}, N={MOMENT_PARTICLES}: kernel route {kernel_ms:.4f} ms"
              f" ({B * 1000.0 / kernel_ms:.1f} settings/s), dense route {dense_ms:.4f} ms"
              f" ({B * 1000.0 / dense_ms:.1f} settings/s) (CUDA events); device time: kernel"
              f" route {kernel_device:.4f} ms (busy share {kernel_device / kernel_ms:.4f}, of it"
              f" B6 stage 1 {gram_device:.4f} ms), dense route {dense_device:.4f} ms (busy share"
              f" {dense_device / dense_ms:.4f}) (torch.profiler, 3 calls; card {card})")
    return b6_launches


def crossover(torch, ltt, ft, fused, ParticleBeam, card):
    """B5 against B6 forced (PACKED_MOMENT_SWEEP) on path A's plan at
    MOMENT_PARTICLES, forward only, float."""
    particles = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=101).particles[0]
    faster = None
    for B in CROSSOVER_BATCHES:
        ops = kernel_operands(torch, ft, fused, aperture_lattice(torch, ltt, B, "rect", torch.float32),
                              B, particles)
        times, device = {}, {}
        for packed in (False, True):
            name = "B6" if packed else "B5"
            ft.PACKED_MOMENT_SWEEP = packed
            try:
                times[name] = cuda_ms(lambda: ft.fused_particle_moment_sweep(*ops), iters=20)
                device[name] = device_ms(lambda: ft.fused_particle_moment_sweep(*ops),
                                              iters=3)
            finally:
                ft.PACKED_MOMENT_SWEEP = None
        print(f"crossover at B={B}, N={MOMENT_PARTICLES} (path A plan, forward): B5 route"
              f" {times['B5']:.4f} ms, B6 route {times['B6']:.4f} ms per call (CUDA events,"
              f" 20 calls); device time per call: B5 route {device['B5']:.4f} ms, B6 route"
              f" {device['B6']:.4f} ms (torch.profiler, 3 calls; card {card})")
        if faster is None and device["B6"] < device["B5"]:
            faster = B
    print(f"B5/B6 crossover by device time: the B6 route is faster from B={faster} of"
          f" {CROSSOVER_BATCHES} (None: B5's at every B); the route's threshold"
          f" _PACK_SETTINGS stays {ft._PACK_SETTINGS}; card {card}")


def gram_bound(planes, bounds_, aug, w0):
    """(bound_ms, bound_by) of B6 in float on its operands: bytes, the
    operands and the (B, 36) sums once each; operations, per (setting,
    particle) 2 flops per plane row at FP32_FLOPS_PER_S, plus the Gram's 72
    flops (a multiply and an add for each of the 36 sums) in each of its
    GRAM_PARTS bf16 parts at BF16_TENSOR_FLOPS_PER_S; the two times add."""
    pairs = planes.shape[1] * aug.shape[1]
    memory_ms = (nbytes(planes, bounds_, aug, w0) + 36 * planes.shape[1] * aug.element_size()
                 ) / HBM_BYTES_PER_S * 1e3
    compute_ms = (pairs * 2 * planes.shape[0] / FP32_FLOPS_PER_S
                  + pairs * 72 * GRAM_PARTS / BF16_TENSOR_FLOPS_PER_S) * 1e3
    return (memory_ms, "bytes") if memory_ms >= compute_ms else (compute_ms, "operations")


def time_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam, card):
    """B5 at path K's B = 8 and B6 at path A's B = 256 against their plain
    versions, float, N = MOMENT_PARTICLES, with their bounds and, for B5,
    its parent's device time (PARENT_DEVICE_MS).  B5's bound: the cloud, its
    weights, the per-setting scalars and the (B, 36) sums once each; per
    (setting, particle) 2 flops per non-zero map cell, 4 per aperture and 72
    for the 36 weighted sums.  B6's: ``gram_bound``.  B5 is one launch (the
    walk, the block's reduction and, in each setting's last block, the sum
    of its blocks); the wrapper's other GPU work is the zeroing of its
    per-setting counters and the operands' copies."""
    particles = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=111).particles[0]
    gen = torch.Generator(device="cuda").manual_seed(112)
    magnets = torch.rand((8, 5), generator=gen, device="cuda") - 0.5
    walk = kernel_operands(torch, ft, fused, list(env._batched_tuned_segment(magnets)
                                                  .flattened().elements), 8, particles)
    gram = ft._packed_operands(*kernel_operands(
        torch, ft, fused, aperture_lattice(torch, ltt, 256, "rect", torch.float32), 256,
        particles))[0]
    entries, scalars, cloud, weights = walk
    n = cloud.shape[0]
    per_particle = 72 + sum(
        2 * sum(not (isinstance(c, float) and c == 0.0) for row in e[1] for c in row)
        if e[0] == "map" else 4 for e in entries)
    sums_bytes = 36 * 8 * cloud.element_size()
    walk_bound = bound(nbytes(cloud, weights, *scalars) + sums_bytes, 8 * n * per_particle)
    calls = {
        "B5": (lambda: ft.particle_moment_sweep(*walk), lambda: ft._moment_sweep_reference(*walk),
               ("moment_walk_kernel",), "path K, B=8", walk_bound),
        "B6": (lambda: ft.packed_gram(*gram), lambda: ft.packed_gram_reference(*gram),
               ("packed_gram_kernel", "reduce_partials_kernel"), "path A, B=256",
               gram_bound(*gram[1:])),
    }
    timing = {}
    for name, (kernel_call, plain_call, kernels, shape, limit) in calls.items():
        timing[name] = dict(ms=cuda_ms(kernel_call, iters=50),
                            plain_ms=cuda_ms(plain_call, iters=10), bound=limit,
                            library_ms=None)
        device, own = device_ms(kernel_call, iters=5, kernel=kernels[0])
        if len(kernels) > 1:
            _, reduce = device_ms(kernel_call, iters=5, kernel=kernels[1])
            stages = f"stage 1 {own:.5f} ms, stage 2 {reduce:.5f} ms, both {own + reduce:.5f} ms"
        else:
            stages = f"both stages, one launch, {own:.5f} ms"
        plain_device = device_ms(plain_call, iters=2)
        t = timing[name]
        parent = (f"; previous design {PARENT_DEVICE_MS[name]:.5f} ms (PERF.md)"
                  if name in PARENT_DEVICE_MS else "")
        print(f"{name} at {shape}, N={MOMENT_PARTICLES} (float): kernel {t['ms']:.4f} ms,"
              f" plain {t['plain_ms']:.4f} ms per call (CUDA events, host launch cost"
              f" included); device time per call: {stages}, all of the wrapper's GPU work"
              f" {device:.5f} ms, plain {plain_device:.5f} ms (torch.profiler); bound"
              f" {limit[0]:.5f} ms ({limit[1]}){parent}; card {card}")
    return timing


# -- the full ARES lattice: path L, fault C1 -------------------------------------


def lattice_window(torch, functional, ParameterBeam, lattice):
    """AREABSCR1's window in the full lattice, derived as ``ares``'s
    ``_derived_ea_window`` derives the EA subcell's (k_sigma = 5): the
    nominal flagship beam tracked as a ParameterBeam from the lattice's
    start to the screen plane, on the CPU."""
    probe = copy.deepcopy(lattice).to("cpu")
    probe = probe.subcell(probe.elements[0].name, "AREABSCR1")
    probe.AREABSCR1.is_active = False
    nominal = ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        sigma_xp=torch.tensor([2e-5]), sigma_yp=torch.tensor([2e-5]),
        sigma_s=torch.tensor([8e-6]), sigma_p=torch.tensor([2e-3]),
        energy=torch.tensor([1.073e8]), device="cpu",
    )
    at_screen, _ = functional.track(probe, nominal)
    return probe.AREABSCR1.derive_histogram_window(at_screen, k_sigma=5.0)


def path_lattice_read(torch, ares, functional, hist, ParticleBeam, ParameterBeam, card):
    """Path L, the read: a 100k-particle f32 beam from the full lattice's
    start to an active AREABSCR1, the EA quadrupoles at the flagship working
    point, the rest as in the file; B1 serves the read; the image against
    the CPU path's."""
    lattice = ares.ares_lattice(device="cuda")
    for name, k1 in ares.FLAGSHIP_K1.items():
        getattr(lattice, name).k1 = torch.tensor([k1], device="cuda")
    window = lattice_window(torch, functional, ParameterBeam, lattice)
    lattice.AREABSCR1.histogram_window = window
    lattice.AREABSCR1.is_active = True
    _, beam = flagship(torch, ares, ParticleBeam, 1, "cuda", seed=61)
    hist.window_histogram.launches = 0
    hist.reset_histogram_fallback_count()
    _, diagnostics = functional.track(lattice, beam)
    image = diagnostics["AREABSCR1"]
    torch.cuda.synchronize()
    launches, fallbacks = hist.window_histogram.launches, hist.histogram_fallback_count()
    print(f"path L (read): {len(lattice.elements)} elements to AREABSCR1, window {window};"
          f" B1 launches {launches} ({hist.READ_LAUNCHES} a read), scatter fallbacks {fallbacks}")
    if launches != hist.READ_LAUNCHES or fallbacks != 0:
        raise AssertionError("path L: the read did not go through kernel B1")
    if tuple(image.shape) != (1, 2040, 2448) or not bool(torch.isfinite(image).all()):
        raise AssertionError(f"path L: bad image {tuple(image.shape)}")
    _, diagnostics = functional.track(copy.deepcopy(lattice).to("cpu"), beam.to("cpu"))
    image_cpu = diagnostics["AREABSCR1"]
    mass, mass_cpu = float(image.sum()), float(image_cpu.sum())
    l1 = float((image.cpu() - image_cpu).abs().sum())
    print(f"path L (read): image mass {mass:.0f} (CPU path {mass_cpu:.0f}, {N_PARTICLES}"
          f" particles), L1 against the CPU path's image {l1:.0f} (bound {2 * MAX_MOVED})")
    if mass != mass_cpu or l1 > 2 * MAX_MOVED:
        raise AssertionError("path L: GPU and CPU images differ")
    ms = cuda_ms(lambda: functional.track(lattice, beam), iters=20)
    device, b1 = device_ms(lambda: functional.track(lattice, beam), iters=5,
                           kernel="windowed_read_")
    print(f"path L (read): track + read {ms:.4f} ms/call (CUDA events, 20 calls); device time"
          f" {device:.4f} ms/call (busy share {device / ms:.4f}), of it B1 {b1:.5f} ms"
          f" (torch.profiler, 5 calls; card {card})")
    time_read(torch, hist, screen_read_args(lattice, beam), card, "path L")
    return launches


def lattice_runs(fused, lattice, energy, B, torch):
    """The fused sweep's plans of a lattice's runs between its non-skippable
    elements, as ``segment._fused_flush`` builds them: (entries, values)."""
    plans = []
    for run in skippable_runs(lattice.flattened().elements):
        plan = fused.plan_run([fused.element_map_builder(el) for el in run], energy,
                              lambda x: torch.broadcast_to(x, (B,)).reshape(B))
        plans.append((tuple((kind, meta, len(values)) for kind, meta, values in plan),
                      [v.detach() for _, _, vs in plan for v in vs]))
    return plans


def path_lattice_sweep(torch, ltt, ares, ft, fused, hist, functional, segment_module, card):
    """Path L, the sweep: an f32 ParameterBeam through the full lattice at
    LATTICE_BATCH settings (every quadrupole's k1, corrector's angle,
    solenoid's k and dipole's angle per setting); the forward through B3,
    the value and gradient of sum(sigma_x + sigma_y) through B4; held
    against the dense route."""
    B = LATTICE_BATCH
    lattice = ares.ares_lattice(device="cuda")
    tuned = tune_lattice(torch, lattice, B, seed=62, requires_grad=True)
    nominal = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        sigma_xp=torch.tensor([2e-5]), sigma_yp=torch.tensor([2e-5]),
        sigma_s=torch.tensor([8e-6]), sigma_p=torch.tensor([2e-3]),
        energy=torch.tensor([1.073e8]), device="cuda",
    )
    # B settings of one beam at one energy: the energy stays (1,), so the
    # untuned elements pre-compose into const groups.
    beam = ltt.ParameterBeam(nominal._mu.expand(B, 7).contiguous(),
                             nominal._cov.expand(B, 7, 7).contiguous(), nominal.energy)

    def loss_of(outgoing):
        return torch.sum(outgoing.sigma_x + outgoing.sigma_y)

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        outgoing, _ = functional.track(lattice, beam)
        grads = torch.autograd.grad(loss_of(outgoing), tuned)
        torch.cuda.synchronize()
    launched = counts(ft)
    runs = lattice_runs(fused, lattice, beam.energy, B, torch)
    entries = [len(entries) for entries, _ in runs]
    print(f"path L (sweep): {len(lattice.elements)} elements at B={B}, {len(tuned)} tuned fields,"
          f" runs of {entries} tape entries; launches {launched}, plain versions on CUDA"
          f" tensors {plain['count']}")
    if launched["B3"] != len(runs) or launched["B4"] != len(runs) or plain["count"]:
        raise AssertionError("path L did not run every run through kernels B3 and B4")
    if outgoing._mu.shape != (B, 7) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("path L: bad output or gradient")

    # The reference: the dense route in double, the same settings (drawn in
    # double, then rounded for the float lattice); beside it the dense route
    # in float, whose own error scales the gradient's bound: through 96 maps
    # a float gradient carries more rounding than path T's 11.
    lattice64 = ares.ares_lattice(dtype=torch.float64, device="cuda")
    tuned64 = tune_lattice(torch, lattice64, B, seed=62, requires_grad=True)
    beam64 = ltt.ParameterBeam(beam._mu.double(), beam._cov.double(), beam.energy.double())
    segment_module.FUSED_SWEEP_PATH = False
    try:
        dense, _ = functional.track(lattice64, beam64)
        dense_grads = torch.autograd.grad(loss_of(dense), tuned64)
        dense32, _ = functional.track(lattice, beam)
        dense32_grads = torch.autograd.grad(loss_of(dense32), tuned)
    finally:
        segment_module.FUSED_SWEEP_PATH = None

    def errors(out, out_grads):
        moments = max(relative_error(torch, a, b, per_setting=False) for a, b in (
            (out.sigma_x, dense.sigma_x), (out.sigma_y, dense.sigma_y),
            (out.mu_x, dense.mu_x), (out.mu_y, dense.mu_y)))
        return moments, max(relative_error(torch, g, d, per_setting=False)
                            for g, d in zip(out_grads, dense_grads))

    moments, gradient = errors(outgoing, grads)
    dense_moments, dense_gradient = errors(dense32, dense32_grads)
    grad_bound = max(GRAD_RTOL, 2 * dense_gradient)
    print(f"path L (sweep): against the dense route in double, of each quantity's largest"
          f" |value|: the B3/B4 route (float) moments {moments:.2e}, gradients {gradient:.2e};"
          f" the dense route in float {dense_moments:.2e}, {dense_gradient:.2e} (bounds"
          f" {OBS_RTOL}, {grad_bound:.2e}: the larger of {GRAD_RTOL} and twice the dense float"
          f" route's)")
    if moments > OBS_RTOL or gradient > grad_bound:
        raise AssertionError("path L: the B3/B4 route and the dense route disagree")

    def forward():
        functional.track(lattice, beam)

    def both():
        out, _ = functional.track(lattice, beam)
        torch.autograd.grad(loss_of(out), tuned)

    forward_ms, both_ms = cuda_ms(forward, iters=5), cuda_ms(both, iters=5)
    device, b3 = device_ms(forward, iters=3, kernel="moment_sweep_kernel")
    device_both, b4 = device_ms(both, iters=3, kernel="moment_sweep_bwd_kernel")
    mu = torch.zeros((B, 7), device="cuda")
    cov = torch.zeros((B, 7, 7), device="cuda")
    full = torch.full((B,), 1.073e8, device="cuda")
    b3_bound = b4_bound = 0.0
    for run_entries, values in runs:
        bounds = sweep_bounds(ft, run_entries, [v.float() for v in values], full, mu, cov)
        b3_bound, b4_bound = b3_bound + bounds[0][0], b4_bound + bounds[1][0]
    print(f"path L (sweep): forward {forward_ms:.4f} ms, value and gradient {both_ms:.4f} ms per"
          f" call (CUDA events, 5 calls); device time forward {device:.4f} ms, of it B3 {b3:.5f}"
          f" ms (bound {b3_bound:.5f} ms over the runs), value and gradient {device_both:.4f} ms,"
          f" of it B4 {b4:.5f} ms (bound {b4_bound:.5f} ms) (torch.profiler, 3 calls; card {card})")
    return launched


def fodo_plan(torch, fused, B, device):
    """The plan of fodo_lattice(FODO_CELLS) with every quadrupole's k1 per
    setting (|k1| 0.5-5, drawn on the host from one seed) on ``device``:
    ``(entries, values, energy)``, float64."""
    from lynx_tpu_torch.models.fodo import fodo_lattice

    lattice = fodo_lattice(FODO_CELLS, dtype=torch.float64, device=device)
    gen = torch.Generator().manual_seed(63)
    for element in lattice.elements:
        if type(element).__name__ == "Quadrupole":
            sign = 1.0 if float(element.k1) >= 0 else -1.0
            k1 = sign * (0.5 + 4.5 * torch.rand(B, generator=gen, dtype=torch.float64))
            element.k1 = k1.to(device)
    energy = torch.tensor([1.073e8], dtype=torch.float64, device=device)
    plan = fused.plan_run([fused.element_map_builder(el) for el in lattice.elements], energy,
                          lambda x: torch.broadcast_to(x, (B,)).reshape(B))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    return entries, [v for _, _, vs in plan for v in vs], energy.expand(B).contiguous()


def dense_total(torch, ft, tbl, entries, values, energy):
    """The plain version's total map R_{E-1} ... R_0 of a plan as dense
    (B, 7, 7) products, each map from the plain builders on the values'
    device."""
    B, dtype, device = energy.shape[0], energy.dtype, energy.device
    total = torch.eye(7, dtype=dtype, device=device).expand(B, 7, 7)
    offset = 0
    for kind, meta, count in entries:
        vals = list(values[offset:offset + count])
        offset += count
        table = meta(vals, energy) if kind == "dyn" else ft._table_from_layout(meta, vals)
        total = tbl.table_to_batch_last(table, (B,), dtype, device).permute(2, 0, 1) @ total
    return total


def check_long_tape(torch, ft, fused, tbl, card):
    """Fault C1: B4 on fodo_lattice(FODO_CELLS) with every quadrupole batched,
    FODO_BATCH settings, float64: past the prefix products that one
    setting's share of shared memory holds, so it walks the tape in
    segments; against the plain version.  Beside it, the plain version's
    own spread: its moments' cotangents from the maps built on the host
    against those built on the card (two math libraries, two matmuls)."""
    B = FODO_BATCH
    entries, values, full = fodo_plan(torch, fused, B, "cuda")
    library = ft.moment_sweep_bwd_library()
    segment = library.lynx_moment_sweep_bwd_segment(1, len(entries))
    tile = library.lynx_moment_sweep_bwd_tile(1, len(entries))
    gen = torch.Generator(device="cuda").manual_seed(64)
    mu, cov = random_moments(torch, B, gen)
    dmu = torch.randn((B, 7), generator=gen, dtype=torch.float64, device="cuda")
    dcov = torch.randn((B, 7, 7), generator=gen, dtype=torch.float64, device="cuda")
    args = (entries, values, full, mu, cov, dmu, dcov)
    launches = ft.moment_sweep_bwd.launches
    kernel = ft.moment_sweep_bwd(*args)
    torch.cuda.synchronize()
    if ft.moment_sweep_bwd.launches != launches + 1:
        raise AssertionError("C1: B4 did not launch")
    errors = cotangent_errors(torch, ft, entries, values, kernel, ft._reference_sweep_vjp(*args),
                              K1_SMALL_RTOL)

    def moment_cotangents(total):
        t = total.transpose(1, 2)
        return (t @ dmu[..., None])[..., 0], t @ dcov @ total

    host_plan = fodo_plan(torch, fused, B, "cpu")
    host = moment_cotangents(dense_total(torch, ft, tbl, *host_plan).cuda())
    spread = max(relative_error(torch, h, c) for h, c in
                 zip(host, moment_cotangents(dense_total(torch, ft, tbl, entries, values, full))))
    bound = max(DOUBLE_RTOL, SPREAD_FACTOR * spread)
    device, own = device_ms(lambda: ft.moment_sweep_bwd(*args), iters=3,
                                 kernel="moment_sweep_bwd_kernel")
    print(f"C1: B4 on fodo_lattice({FODO_CELLS}), every quadrupole batched, B={B}, double:"
          f" {len(entries)} tape entries in segments of {segment}, {tile} settings a block;"
          f" against the plain version values {errors[0]:.2e}, moments {errors[1]:.2e}, energy"
          f" {errors[3]:.2e} per setting (bound {bound:.2e}: {SPREAD_FACTOR} times the plain"
          f" version's own spread in the moments' cotangents, maps built on the host against the"
          f" card, {spread:.2e}); device time {own:.4f} ms (the wrapper's GPU work"
          f" {device:.4f} ms; torch.profiler, 3 calls; card {card})")
    if (len(entries) <= 514 or segment >= len(entries) or max(errors[:2]) > bound
            or errors[3] > bound):
        raise AssertionError("C1: B4 past the shared memory disagrees or did not take segments")
    return errors


# -- path I: the beam and lattice I/O slice ------------------------------------

RESOURCES = Path(__file__).resolve().parent / "tests" / "resources"
ASTRA_BEAM = RESOURCES / "ACHIP_EA1_2021.1351.001"  # 100,000 particles at 107.3 MeV
NX_TABLES = RESOURCES / "nxtables_ares_stage4.csv"  # the ARES stage-4 device table
NX_ELEMENTS = 235
NX_READ_CELL = ("AREASOLA1", "ARMRBSCR1")  # path I2a's subcell: 45 elements, 6.48 m
# The particle beam's Twiss values against ParameterBeam.from_astra's at
# the same plane.  They differ by design in one term: the particle beam's
# x-x' and y-y' correlations are population moments (ddof = 0, as the
# reference's), np.cov's are ddof = 1, and the emittance's cancellation
# (eps^2 = s^2 s'^2 - c^2) amplifies that 1/N by alpha^2: 1.3e-3 for
# alpha_y = -11.5 at AREABSCR1.  So the particle beam's values with its
# correlations taken at ddof = 1 are held to the ParameterBeam's within
# TWISS_RTOL (float rounding and the tracking beside), and the API's own
# values are printed beside them.
TWISS_RTOL = 1e-3
TWISS = ("emittance_x", "emittance_y", "beta_x", "beta_y", "alpha_x", "alpha_y")


def read_through_b1(torch, hist, functional, segment, screen, beam, label):
    """One read of ``screen`` (active, its window set) by ``beam`` through
    B1: three launches and no fallback, image mass equal to the particle
    count, and within 2 x MAX_MOVED L1 of the CPU path's image on the same
    particles.  Returns the image and B1's launches."""
    hist.window_histogram.launches = 0
    hist.reset_histogram_fallback_count()
    _, diagnostics = functional.track(segment, beam)
    image = diagnostics[screen]
    torch.cuda.synchronize()
    launches, fallbacks = hist.window_histogram.launches, hist.histogram_fallback_count()
    _, diagnostics = functional.track(copy.deepcopy(segment).to("cpu"), beam.to("cpu"))
    image_cpu = diagnostics[screen]
    mass, mass_cpu = float(image.sum()), float(image_cpu.sum())
    l1 = float((image.cpu() - image_cpu).abs().sum())
    print(f"{label}: {screen} image {tuple(image.shape)}, B1 launches {launches}"
          f" ({hist.READ_LAUNCHES} a read), scatter fallbacks {fallbacks}; image mass {mass:.0f}"
          f" (CPU path {mass_cpu:.0f}, {beam.num_particles} particles), L1 against the CPU"
          f" path's image {l1:.0f} (bound {2 * MAX_MOVED})")
    if launches != hist.READ_LAUNCHES or fallbacks != 0:
        raise AssertionError(f"{label}: the read did not go through kernel B1")
    if not bool(torch.isfinite(image).all()) or mass != beam.num_particles or mass_cpu != mass:
        raise AssertionError(f"{label}: bad image")
    if l1 > 2 * MAX_MOVED:
        raise AssertionError(f"{label}: GPU and CPU images differ")
    return image, launches


def screen_window(functional, segment, screen, beam):
    """``screen``'s window derived as ``lattice_window`` derives
    AREABSCR1's (k_sigma = 5), from ``beam`` (a ParameterBeam on the CPU)
    tracked to the screen's plane on the CPU."""
    probe = copy.deepcopy(segment).to("cpu")
    getattr(probe, screen).is_active = False
    at_screen, _ = functional.track(probe, beam)
    return getattr(probe, screen).derive_histogram_window(at_screen, k_sigma=5.0)


def twiss_at(functional, segment, screen, beam):
    """The beam's Twiss values at ``screen``'s plane (an active screen
    absorbs the beam, so the track runs with the screen inactive), and for
    a particle beam also those with its correlations at ddof = 1."""
    probe = copy.deepcopy(segment)
    getattr(probe, screen).is_active = False
    out, _ = functional.track(probe, beam)
    api = {name: float(getattr(out, name)) for name in TWISS}
    if not hasattr(out, "num_particles"):
        return api, api
    n = out.num_particles
    ddof1 = {}
    for plane, sigma, sigma_p, corr in (("x", out.sigma_x, out.sigma_xp, out.sigma_xxp),
                                        ("y", out.sigma_y, out.sigma_yp, out.sigma_yyp)):
        sigma, sigma_p, corr = float(sigma), float(sigma_p), float(corr) * n / (n - 1)
        emittance = (sigma**2 * sigma_p**2 - corr**2) ** 0.5
        ddof1.update({f"emittance_{plane}": emittance, f"beta_{plane}": sigma**2 / emittance,
                      f"alpha_{plane}": -corr / emittance})
    return api, ddof1


def path_io_astra(torch, ltt, ares, functional, hist, card):
    """Path I1: the ASTRA beam on the flagship screen.  The beam read from
    the file; ``ares_lattice()`` written as LatticeJSON and read back; the
    round trip's EA subcell reads AREABSCR1 through B1 for the beam and for
    ``transformed_to`` a moved spot, each image the same as the original
    lattice's; the Twiss values at AREABSCR1's plane of both beam types
    from the file, held to each other."""
    start = time.perf_counter()
    beam = ltt.ParticleBeam.from_astra(str(ASTRA_BEAM), device="cuda")
    torch.cuda.synchronize()
    particle_s = time.perf_counter() - start
    start = time.perf_counter()
    moments = ltt.ParameterBeam.from_astra(str(ASTRA_BEAM), device="cuda")
    torch.cuda.synchronize()
    parameter_s = time.perf_counter() - start
    print(f"path I1: from_astra {beam.num_particles} particles at {float(beam.energy):.6e} eV:"
          f" ParticleBeam {particle_s:.3f} s, ParameterBeam {parameter_s:.3f} s (host clock,"
          f" the file read and converted on the host; card {card})")

    original = ares.ares_ea_segment(device="cuda")
    with tempfile.TemporaryDirectory() as directory:
        path = Path(directory) / "ares_lattice.json"
        ares.ares_lattice(device="cuda").to_lattice_json(str(path))
        loaded = ltt.Segment.from_lattice_json(str(path), device="cuda")
    segment = loaded.subcell("AREASOLA1", "AREABSCR1")
    segment.AREABSCR1.histogram_window = original.AREABSCR1.histogram_window
    for seg in (original, segment):
        seg.AREABSCR1.is_active = True
        for name, k1 in ares.FLAGSHIP_K1.items():
            getattr(seg, name).k1 = torch.tensor([k1], device="cuda")
    if segment != original:
        raise AssertionError("path I1: the LatticeJSON round trip changed the EA subcell")

    moved = beam.transformed_to(mu_x=torch.tensor([1e-4]), mu_y=torch.tensor([-1e-4]))
    launches = 0
    for label, read_beam in (("as loaded", beam), ("moved", moved)):
        image, read_launches = read_through_b1(torch, hist, functional, segment, "AREABSCR1",
                                               read_beam, f"path I1 ({label})")
        launches += read_launches
        _, diagnostics = functional.track(original, read_beam)
        if not torch.equal(image, diagnostics["AREABSCR1"]):
            raise AssertionError("path I1: the round-tripped lattice reads another image")
    print("path I1: the round-tripped lattice reads the original lattice's images exactly")

    (api, particle), (parameter, _) = (twiss_at(functional, segment, "AREABSCR1", b)
                                       for b in (beam, moments))

    def worst(values):
        return max(abs(values[k] - parameter[k]) / abs(parameter[k]) for k in TWISS)

    print("path I1: at AREABSCR1's plane, ParticleBeam (correlations at ddof = 1 / the API's"
          " ddof = 0) against ParameterBeam: " + ", ".join(
              f"{k} {particle[k]:.6e} / {api[k]:.6e} against {parameter[k]:.6e}" for k in TWISS)
          + f"; largest relative difference {worst(particle):.2e} (bound {TWISS_RTOL}), the"
          f" API's {worst(api):.2e}")
    if worst(particle) > TWISS_RTOL:
        raise AssertionError("path I1: the two beam types' Twiss values disagree")

    ms = cuda_ms(lambda: functional.track(segment, beam), iters=50)
    device, b1 = device_ms(lambda: functional.track(segment, beam), iters=5,
                           kernel="windowed_read_")
    print(f"path I1: track + read {ms:.4f} ms/call (CUDA events, 50 calls); device time"
          f" {device:.4f} ms/call (busy share {device / ms:.4f}), of it B1 {b1:.5f} ms"
          f" (torch.profiler, 5 calls; card {card})")
    return launches


def path_io_nx_read(torch, ltt, functional, hist, card):
    """Path I2a: the ASTRA beam through the NX-tables lattice's subcell
    AREASOLA1 ... ARMRBSCR1, read on ARMRBSCR1 through B1 (window derived
    from the beam at that plane)."""
    lattice = ltt.Segment.from_nx_tables(NX_TABLES, device="cuda")
    if len(lattice.elements) != NX_ELEMENTS:
        raise AssertionError(f"path I2: {len(lattice.elements)} elements, expected {NX_ELEMENTS}")
    segment = lattice.subcell(*NX_READ_CELL)
    screen = NX_READ_CELL[1]
    beam = ltt.ParticleBeam.from_astra(str(ASTRA_BEAM), device="cuda")
    window = screen_window(functional, segment, screen,
                           ltt.ParameterBeam.from_astra(str(ASTRA_BEAM), device="cpu"))
    getattr(segment, screen).histogram_window = window
    getattr(segment, screen).is_active = True
    print(f"path I2a: {len(segment.elements)} elements, {float(segment.length):.4f} m to {screen}"
          f" ({getattr(segment, screen).resolution}), window {window}")
    _, launches = read_through_b1(torch, hist, functional, segment, screen, beam, "path I2a")
    ms = cuda_ms(lambda: functional.track(segment, beam), iters=20)
    device, b1 = device_ms(lambda: functional.track(segment, beam), iters=5,
                           kernel="windowed_read_")
    print(f"path I2a: track + read {ms:.4f} ms/call (CUDA events, 20 calls); device time"
          f" {device:.4f} ms/call (busy share {device / ms:.4f}), of it B1 {b1:.5f} ms"
          f" (torch.profiler, 5 calls; card {card})")
    return launches


def path_io_nx_sweep(torch, ltt, ft, fused, hist, functional, segment_module, card):
    """Path I2b: a float ParameterBeam with the ASTRA beam's own Twiss
    values through the whole NX-tables lattice at LATTICE_BATCH settings
    (every quadrupole's k1 and every corrector's angle per setting, drawn
    as path L draws them); the forward through B3, the value and gradient
    of sum(beta_x + beta_y) through B4; held against the dense route in
    double within path L's bounds."""
    B = LATTICE_BATCH
    kinds = ("Quadrupole", "HorizontalCorrector", "VerticalCorrector")
    lattice = ltt.Segment.from_nx_tables(NX_TABLES, device="cuda")
    tuned = tune_lattice(torch, lattice, B, seed=63, requires_grad=True, kinds=kinds)
    astra = ltt.ParameterBeam.from_astra(str(ASTRA_BEAM), device="cuda")
    nominal = ltt.ParameterBeam.from_twiss(
        beta_x=astra.beta_x, alpha_x=astra.alpha_x, emittance_x=astra.emittance_x,
        beta_y=astra.beta_y, alpha_y=astra.alpha_y, emittance_y=astra.emittance_y,
        sigma_s=astra.sigma_s, sigma_p=astra.sigma_p, energy=astra.energy, device="cuda",
    )
    beam = ltt.ParameterBeam(nominal._mu.expand(B, 7).contiguous(),
                             nominal._cov.expand(B, 7, 7).contiguous(), nominal.energy)

    def loss_of(outgoing):
        return torch.sum(outgoing.beta_x + outgoing.beta_y)

    runs = lattice_runs(fused, lattice, beam.energy, B, torch)
    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        outgoing, _ = functional.track(lattice, beam)
        grads = torch.autograd.grad(loss_of(outgoing), tuned)
        torch.cuda.synchronize()
    launched = counts(ft)
    print(f"path I2b: {len(lattice.elements)} elements at B={B}, {len(tuned)} tuned fields,"
          f" runs of {[len(entries) for entries, _ in runs]} tape entries; launches {launched},"
          f" plain versions on CUDA tensors {plain['count']}")
    if launched["B3"] != len(runs) or launched["B4"] != len(runs) or plain["count"]:
        raise AssertionError("path I2b did not run every run through kernels B3 and B4")
    if outgoing._mu.shape != (B, 7) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("path I2b: bad output or gradient")

    # The reference: the dense route in double on the same settings.  The
    # moments are held as path L holds them.  These draws blow most
    # settings' beams up over the 44 m (1 + alpha_y^2 has a median ~1e8 at
    # the end), and beta = sigma^2 / eps takes eps from eps^2 = s^2 s'^2 -
    # c^2, which cancels by 1 + alpha^2: float carries beta, and the loss's
    # own derivative, only on the tamer settings (the dense route in float
    # no better).  So the gradient is held as B3/B4 compute it: the VJP of
    # the loss's cotangents (from the float outputs, scaled to 1 per
    # setting) through the runs' maps, against the dense route in double on
    # the same cotangents, beside the dense route in float; and beta's
    # agreement is counted per setting.
    lattice64 = ltt.Segment.from_nx_tables(NX_TABLES, dtype=torch.float64, device="cuda")
    tuned64 = tune_lattice(torch, lattice64, B, seed=63, requires_grad=True, kinds=kinds)
    beam64 = ltt.ParameterBeam(beam._mu.double(), beam._cov.double(), beam.energy.double())
    (d_cov,) = torch.autograd.grad(loss_of(outgoing), (outgoing._cov,))
    d_mu = torch.zeros_like(outgoing._mu)  # beta does not depend on the means
    scale = torch.maximum(d_mu.abs().amax(dim=1), d_cov.abs().amax(dim=(1, 2))).clamp_min(1e-30)
    d_mu, d_cov = d_mu / scale[:, None], d_cov / scale[:, None, None]

    def vjp(out, params):
        return torch.autograd.grad((out._mu, out._cov), params,
                                   (d_mu.to(out._mu.dtype), d_cov.to(out._mu.dtype)))

    kernel_vjp = vjp(functional.track(lattice, beam)[0], tuned)
    segment_module.FUSED_SWEEP_PATH = False
    try:
        dense, _ = functional.track(lattice64, beam64)
        dense_vjp = vjp(dense, tuned64)
        dense32, _ = functional.track(lattice, beam)
        dense32_vjp = vjp(dense32, tuned)
    finally:
        segment_module.FUSED_SWEEP_PATH = None

    def errors(out, out_vjp):
        moments = max(relative_error(torch, getattr(out, k), getattr(dense, k), per_setting=False)
                      for k in ("sigma_x", "sigma_y", "mu_x", "mu_y"))
        agree = torch.ones_like(dense.beta_x, dtype=torch.bool)
        for k in ("beta_x", "beta_y"):
            agree &= (getattr(out, k).double() - getattr(dense, k)).abs() <= (
                TWISS_RTOL * getattr(dense, k).abs())
        return moments, int(agree.sum()), max(relative_error(torch, g, d, per_setting=False)
                                               for g, d in zip(out_vjp, dense_vjp))

    moments, beta_agree, gradient = errors(outgoing, kernel_vjp)
    dense_moments, dense_beta_agree, dense_gradient = errors(dense32, dense32_vjp)
    grad_bound = max(GRAD_RTOL, 2 * dense_gradient)
    loss = float(loss_of(outgoing).detach())
    print(f"path I2b: against the dense route in double, of each quantity's largest |value|:"
          f" the B3/B4 route (float) moments {moments:.2e}, the VJP of the loss's cotangents"
          f" {gradient:.2e}; the dense route in float {dense_moments:.2e}, {dense_gradient:.2e}"
          f" (bounds {OBS_RTOL}, {grad_bound:.2e}: path L's); beta_x and beta_y within"
          f" {TWISS_RTOL} of double on {beta_agree} of {B} settings ({dense_beta_agree} in the"
          f" dense route in float); sum(beta_x + beta_y) {loss:.6e} (double"
          f" {float(loss_of(dense).detach()):.6e})")
    if moments > OBS_RTOL or gradient > grad_bound or not math.isfinite(loss):
        raise AssertionError("path I2b: the B3/B4 route and the dense route disagree")

    def forward():
        functional.track(lattice, beam)

    def both():
        out, _ = functional.track(lattice, beam)
        torch.autograd.grad(loss_of(out), tuned)

    forward_ms, both_ms = cuda_ms(forward, iters=5), cuda_ms(both, iters=5)
    device, b3 = device_ms(forward, iters=3, kernel="moment_sweep_kernel")
    device_both, b4 = device_ms(both, iters=3, kernel="moment_sweep_bwd_kernel")
    print(f"path I2b: forward {forward_ms:.4f} ms, value and gradient {both_ms:.4f} ms per call"
          f" (CUDA events, 5 calls); device time forward {device:.4f} ms, of it B3 {b3:.5f} ms,"
          f" value and gradient {device_both:.4f} ms, of it B4 {b4:.5f} ms (torch.profiler,"
          f" 3 calls; card {card})")
    return launched


# -- kernel B7: the count-histogram A/B ----------------------------------------


def relative_spread(torch, a, b):
    """max |a - b| over the largest |b|, a tensor or each of a list of them
    (the worst over the list)."""
    pairs = zip(a, b) if isinstance(a, (list, tuple)) else [(a, b)]
    return max(float((x.detach().double().cpu() - y.detach().double().cpu()).abs().max()
                     / y.detach().double().abs().max().cpu().clamp_min(1e-300))
               for x, y in pairs)


def ppo_update_on_cpu(torch, envs, ppo, policy, params, magnets, noise, dtype):
    """The first PPO update on the CPU in ``dtype``: the same weights, env
    params, initial magnets and noise, moved to the CPU; the initial
    observation recomputed there.  Returns (loss, mean reward, gradients)."""
    env = envs.make_env(dtype=dtype, device="cpu")
    params = envs.EnvParams(*(x.to("cpu", dtype) for x in params[:3]))
    policy = copy.deepcopy(policy).to("cpu", dtype)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
    magnets = magnets.to("cpu", dtype)
    with torch.no_grad():
        obs = env._observe(magnets, env.batched_beam_parameters(magnets, params), params.target)
    states = envs.EnvState(magnets, torch.zeros(magnets.shape[0], dtype=torch.int32), None)
    update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT, graph=False)
    _, _, loss, reward = update(policy, obs, states, noise=noise.to("cpu", dtype))
    return loss, reward, [p.grad for p in policy.parameters()]


def path_rl_ppo(torch, ft, hist, envs, ppo, profiling, card):
    """R1: PPO on the env at SWEEP_BATCH settings, PPO_UPDATES updates of a
    PPO_ROLLOUT rollout through ``collect_and_update``, every env step
    through B3; the first update held against the same update on the CPU in
    double, the loss, mean reward and gradient each within SPREAD_FACTOR
    times the CPU path's own float-against-double spread of it;
    env-transitions/s, the device's busy share and B3's, the
    top device ops; one update at the example's PPO_DEFAULT_ENVS (dense
    route).  R1 runs the eager step (``graph=False``); J8 replays it.
    Returns (the launches, R1's env, params and states, and what J8 holds
    its graph form to: the initial policy, the start, the noise, the first
    update and the CPU's spreads)."""
    B = SWEEP_BATCH
    env = envs.make_env(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    params = envs.default_params(gen, device="cuda", batch_shape=(B,))
    policy = ppo.MLPPolicy(env.obs_size, env.num_actions, generator=gen, device="cuda")
    initial_policy = copy.deepcopy(policy)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
    update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT, graph=False)
    noise = torch.randn((PPO_ROLLOUT, B, env.num_actions), generator=gen, device="cuda")

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        obs, states = env.batched_reset(gen, params)
        magnets, obs0 = states.magnets.clone(), obs.clone()
        history = []
        for i in range(PPO_UPDATES):
            obs, states, loss, reward = update(policy, obs, states, gen,
                                               noise=noise if i == 0 else None)
            if i == 0:
                first = (loss, reward, [p.grad.clone() for p in policy.parameters()])
            history.append((loss, reward))
        torch.cuda.synchronize()
    launched = counts(ft)  # the path's own launches, before any timing
    history = [(float(loss), float(reward)) for loss, reward in history]
    print(f"path R1: PPO at B={B} envs, rollout {PPO_ROLLOUT}, {PPO_UPDATES} updates: (loss, mean"
          f" reward) {history}; launches {launched}, plain versions on CUDA tensors"
          f" {plain['count']}")
    if launched["B3"] != PPO_ROLLOUT * PPO_UPDATES + 1 or plain["count"]:
        raise AssertionError("path R1 did not run every env step through kernel B3")
    if not all(math.isfinite(x) for pair in history for x in pair):
        raise AssertionError("path R1: non-finite losses")
    if int(states.step_count[0]) != PPO_ROLLOUT * PPO_UPDATES:
        raise AssertionError("path R1: bad step counts")

    # The first update against the same update on the CPU in double.
    start = time.perf_counter()
    cpu = {dtype: ppo_update_on_cpu(torch, envs, ppo, initial_policy, params, magnets, noise,
                                    dtype)
           for dtype in (torch.float64, torch.float32)}
    reference, other = cpu[torch.float64], cpu[torch.float32]
    names = ("loss", "mean reward", "gradient")
    spreads = {name: relative_spread(torch, a, b) for name, a, b in zip(names, other, reference)}
    errors = {name: relative_spread(torch, a, b) for name, a, b in zip(names, first, reference)}
    print(f"path R1: first update (GPU, float) against the CPU in double, each quantity within"
          f" {SPREAD_FACTOR} x the CPU path's own float-against-double spread of it (gradient:"
          f" each tensor's largest |difference| over its largest |value|, the worst tensor): "
          + ", ".join(f"{name} error {errors[name]:.2e}, spread {spreads[name]:.2e}, bound"
                      f" {SPREAD_FACTOR * spreads[name]:.2e}" for name in names)
          + f"; CPU updates {time.perf_counter() - start:.1f} s")
    if any(errors[name] > SPREAD_FACTOR * spreads[name] for name in names):
        raise AssertionError("path R1: the first update disagrees with the CPU's in double")

    def one_update():
        return update(policy, obs, states, gen)

    ms = cuda_ms(one_update, iters=3, warmup=1)
    device_total, sweep = device_ms(one_update, iters=2, kernel="moment_sweep_kernel")
    print(f"path R1: collect_and_update at B={B}, rollout {PPO_ROLLOUT}: {ms:.4f} ms/update,"
          f" {B * PPO_ROLLOUT * 1000.0 / ms:.1f} env-transitions/s (CUDA events, 3 updates after"
          f" warm-up); device time {device_total:.4f} ms/update (busy share"
          f" {device_total / ms:.4f}), of it B3 {sweep:.4f} ms (share {sweep / device_total:.4f};"
          f" torch.profiler, 2 updates; card {card})")
    rows = profiling.device_op_profile(one_update, iters=2, top=10)
    print("path R1: top device ops per update (profiling.device_op_profile, 2 updates):")
    for row in rows:
        print(f"  {row['us_per_iter']:12.2f} us  x{row['count_per_iter']:g}  {row['name'][:100]}")

    # One update at the example's default width, on the dense route.
    small_gen = torch.Generator(device="cuda").manual_seed(42)
    small_params = envs.default_params(small_gen, device="cuda", batch_shape=(PPO_DEFAULT_ENVS,))
    small_update = ppo.make_collect_and_update(env, small_params, optimizer, PPO_ROLLOUT,
                                               graph=False)
    small_obs, small_states = env.batched_reset(small_gen, small_params)
    reset_counts(ft, hist)
    _, _, small_loss, _ = small_update(policy, small_obs, small_states, small_gen)
    torch.cuda.synchronize()
    small_launched = counts(ft)
    small_ms = cuda_ms(lambda: small_update(policy, small_obs, small_states, small_gen), iters=3,
                       warmup=1)
    print(f"path R1: one update at the example's default B={PPO_DEFAULT_ENVS} envs (dense route):"
          f" {small_ms:.4f} ms/update, {PPO_DEFAULT_ENVS * PPO_ROLLOUT * 1000.0 / small_ms:.1f}"
          f" env-transitions/s (CUDA events, 3 updates); launches {small_launched}; loss"
          f" {float(small_loss):.4f} (card {card})")
    if small_launched["B3"] or not math.isfinite(float(small_loss)):
        raise AssertionError("path R1: the default-width update left the dense route")
    context = dict(policy=initial_policy, params=params, obs=obs0, magnets=magnets, noise=noise,
                   first=first, spreads=spreads, ms=ms, small_ms=small_ms)
    return launched, (env, params, states), context


def path_rl_metrics(torch, envs, env_state, card):
    """R2: one batched_step at SWEEP_BATCH with log_metrics on emits one
    metric line, step=1 and the five keys, whose values are the step's
    observation means; its time beside the same step with metrics off."""
    import logging

    env, params, states = env_state
    env_on = envs.make_env(log_metrics=True, device="cuda")
    start = envs.EnvState(states.magnets, torch.zeros_like(states.step_count), None)
    actions = torch.tanh(states.magnets * 2.0)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("lynx_tpu_torch.metrics")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        obs, _, rewards, _ = env_on.batched_step(start, actions, params)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    print(f"path R2: log_metrics at B={SWEEP_BATCH}: {lines}")
    if len(lines) != 1 or not lines[0].startswith("step=1 "):
        raise AssertionError("path R2: expected one metric line at step=1")
    values = dict(part.split("=") for part in lines[0].split()[1:])
    expected = dict(zip(("mu_x", "sigma_x", "mu_y", "sigma_y"),
                        (obs[:, 5:9].double().mean(dim=0) / 1e3).tolist()))
    expected["reward"] = float(rewards.double().mean())
    if sorted(values) != sorted(expected):
        raise AssertionError(f"path R2: keys {sorted(values)}")
    columns = torch.cat([obs[:, 5:9].double() / 1e3, rewards.double()[:, None]], dim=1)
    scales = dict(zip(("mu_x", "sigma_x", "mu_y", "sigma_y", "reward"),
                      columns.abs().mean(dim=0).tolist()))
    error = max(abs(float(values[k]) - v) / scales[k] for k, v in expected.items())
    print(f"path R2: metric values against the observation's means in double: max error"
          f" {error:.2e} of each column's mean |value| (bound {METRIC_RTOL}: 6 printed digits"
          f" and float32 means)")
    if error > METRIC_RTOL:
        raise AssertionError("path R2: metric values disagree with the observation")
    on_ms = cuda_ms(lambda: env_on.batched_step(start, actions, params), iters=10)
    off_ms = cuda_ms(lambda: env.batched_step(start, actions, params), iters=10)
    print(f"path R2: batched_step at B={SWEEP_BATCH}: {on_ms:.4f} ms with metrics on,"
          f" {off_ms:.4f} ms off (CUDA events, 10 steps; card {card})")


def path_rl_tuning(torch, gradient_tuning, emittance_measurement, image_tuning, card):
    """R3: the tuning examples on the card: gradient_tuning's TUNING_STEPS
    steps lower the loss, the emittance fit lands within EMITTANCE_RTOL of
    the true emittance, image_tuning's loss falls below 1e-3 of its first
    value (the example's own check); ms per tune step of each."""
    for label, run, steps in (
        ("gradient_tuning", lambda: gradient_tuning.main(TUNING_STEPS, device="cuda"),
         TUNING_STEPS),
        ("emittance_measurement", lambda: emittance_measurement.main(device="cuda"), 600),
        ("image_tuning", lambda: image_tuning.main(device="cuda", graph=False), 200),
    ):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        if label == "gradient_tuning":
            losses = result[1]
            if not float(losses[-1]) < float(losses[0]) or not bool(torch.isfinite(losses).all()):
                raise AssertionError("path R3: gradient_tuning's loss did not fall")
            detail = f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} mm"
        elif label == "emittance_measurement":
            error = abs(result["emittance"] / result["true_emittance"] - 1)
            if not error < EMITTANCE_RTOL:
                raise AssertionError(f"path R3: fitted emittance {error:.2e} off")
            detail = (f"fitted emittance {result['emittance']:.5e} against"
                      f" {result['true_emittance']:.5e} m rad, error {error:.2e} (bound"
                      f" {EMITTANCE_RTOL})")
        else:
            params, losses = result
            detail = (f"loss {float(losses[0]):.3e} -> {float(losses[-1]):.3e}, k ="
                      f" {[round(x, 4) for x in params.tolist()]}")
        print(f"path R3: {label}: {detail}; {seconds * 1000.0 / steps:.4f} ms per tune step"
              f" (the example's wall time over its {steps} steps, host clock after"
              f" synchronize; card {card})")


def path_rl_fidelity(torch, ft, hist, particle_fidelity_sweep, card):
    """R4: particle_fidelity_sweep at its B = 64 (B6) and at B = 8 (B5),
    FIDELITY_PARTICLES particles; the kernel route's moments held against
    the plain walk in double on the CPU.  Returns the launches and the
    example's beams."""
    launched, beams = {}, []
    for B in FIDELITY_BATCHES:
        reset_counts(ft, hist)
        with plain_on_cuda_guard(torch, ft) as plain:
            result = particle_fidelity_sweep.main(B, FIDELITY_PARTICLES, device="cuda")
            torch.cuda.synchronize()
        launched[B] = counts(ft)
        route = "B6" if B >= ft._PACK_SETTINGS else "B5"
        other = "B5" if route == "B6" else "B6"
        print(f"path R4: particle_fidelity_sweep at B={B}, N={FIDELITY_PARTICLES}: launches"
              f" {launched[B]}, plain versions on CUDA tensors {plain['count']}")
        if launched[B][route] != 1 or launched[B][other] or plain["count"]:
            raise AssertionError(f"path R4 at B={B} did not go through kernel {route}")
        entries, scalars, particles, weights = result["plan"]
        mu, cov, survivors = result["moments"]
        mu64, cov64, survivors64 = ft.sweep_particle_moments(
            entries, [s.double().cpu() for s in scalars], particles.double().cpu(),
            weights.double().cpu())
        flips = float((survivors.double().cpu() - survivors64).abs().max())
        errors = {}
        for stat, got, want, plane in (
            ("mu_x", mu[:, 0], mu64[:, 0], 0), ("mu_y", mu[:, 2], mu64[:, 2], 2),
            ("sigma_x", cov[:, 0, 0].sqrt(), cov64[:, 0, 0].sqrt(), 0),
            ("sigma_y", cov[:, 2, 2].sqrt(), cov64[:, 2, 2].sqrt(), 2),
        ):
            scale = float(cov64[:, plane, plane].sqrt().max())
            errors[stat] = float((got.double().cpu() - want).abs().max()) / scale
        print(f"path R4: B={B} kernel route against the plain walk (double, CPU): net flipped"
              f" particles per setting <= {flips:.0f} (bound {MAX_FLIPS}); errors relative to the"
              f" plane's largest sigma: {', '.join(f'{k} {v:.2e}' for k, v in errors.items())}"
              f" (bound {KERNEL_OBS_RTOL}); route 1's moments against the dense push, max"
              f" relative {result['drift']:.2e} (printed, as the example prints it; card {card})")
        if flips > MAX_FLIPS or max(errors.values()) > KERNEL_OBS_RTOL:
            raise AssertionError(f"path R4 at B={B}: the kernel route disagrees with the plain walk")
        beams.append(result["beam"])
    return launched, beams


def path_rl_debug(torch, functional, debug, env_state, beams):
    """R5: validate_beam passes on R1's beams (the incoming ParameterBeam of
    SWEEP_BATCH settings and its image at the screen) and on R4's particle
    beams; nan_debug passes a clean card sweep and raises on a NaN injected
    into one setting of it."""
    env, params, states = env_state
    with torch.no_grad():
        incoming = env._incoming(params.incoming_mu, params.incoming_sigma)
        outgoing, _ = functional.track(env._batched_tuned_segment(states.magnets), incoming)
    for label, beam in (("R1 incoming", incoming), ("R1 outgoing", outgoing),
                        *((f"R4 beam {i}", b) for i, b in enumerate(beams))):
        debug.validate_beam(beam, name=label)
    with torch.no_grad(), debug.nan_debug():
        clean = env.batched_beam_parameters(states.magnets, params)
    if not bool(torch.isfinite(clean).all()):
        raise AssertionError("path R5: the clean sweep is not finite")
    magnets = states.magnets.clone()
    magnets[SWEEP_BATCH // 2, 0] = float("nan")
    try:
        with torch.no_grad(), debug.nan_debug():
            env.batched_beam_parameters(magnets, params)
    except FloatingPointError as error:
        caught = str(error)
    else:
        raise AssertionError("path R5: nan_debug did not raise on a NaN setting")
    print(f"path R5: validate_beam passed on R1's incoming and outgoing beams ({SWEEP_BATCH}"
          f" settings) and R4's {len(beams)} beams; nan_debug passed the clean sweep and raised"
          f" on setting {SWEEP_BATCH // 2}'s NaN: {caught}")


def hist_bound(n, win):
    """B7's bound, the same for both kernels: the indices read and the int32
    window written once.  A count histogram needs no arithmetic beyond one
    add a pair, so the bytes bound it."""
    return (8 * n + 4 * win[0] * win[1]) / HBM_BYTES_PER_S * 1e3, "bytes"


def onehot_floor(torch, lx, ly, win):
    """The int8 operations that B7's onehot read issues, at the dense int8
    rate, printed beside B7's bound: the formulation's own cost, not the
    function's.  Each 16-row tile's in-window pairs go through the mma in
    steps of 32 (a bucket's spans are multiples of 32, so ceil(count / 32)
    steps whatever the span), each step one m16n8k32 mma (2 x 16 x 8 x 32
    operations) for each 8-column tile of the window."""
    win_x, win_y = win
    inside = (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < win_y)
    counts = torch.bincount((lx[inside] // 16).long(), minlength=-(-win_x // 16))
    steps = int(((counts + 31) // 32).sum())
    return 2 * 16 * 8 * 32 * steps * -(-win_y // 8) / INT8_OPS_PER_S * 1e3


def path_hist_ab(torch, hist, card):
    """Kernel B7: every variant exactly against the plain version and
    against B1's count mode on the harness's spot, on -1 pads and indices
    past the window, on all-padded and ragged inputs; then the harness
    (its JSON lines, its yardsticks) with the launch counts from 0."""
    from lynx_tpu_torch.benchmarks import hist_ab

    win_x, win_y = WINDOW
    gen = torch.Generator(device="cuda").manual_seed(71)

    def randint(low, high, n):
        return torch.randint(low, high, (n,), generator=gen, device="cuda", dtype=torch.int32)

    cases = {
        "harness spot": hist_ab.workload(N_PARTICLES, WINDOW, seed=0),
        "pads and indices past the window": (randint(-1, win_x + 40, N_PARTICLES + 5),
                                             randint(-1, win_y + 40, N_PARTICLES + 5)),
        "all padded": (torch.full((1000,), -1, dtype=torch.int32, device="cuda"),
                       randint(0, win_y, 1000)),
        "33 particles": (randint(0, win_x, 33), randint(0, win_y, 33)),
        "one bucket: every pair in rows 480-495": (randint(480, 496, N_PARTICLES),
                                                   randint(0, win_y, N_PARTICLES)),
    }
    worst = 0
    for label, (lx, ly) in cases.items():
        plain = hist_ab.hist_ab_reference(lx, ly, win_x, win_y)
        b1 = hist.window_histogram(lx[None].contiguous(), ly[None].contiguous(), None,
                                   win_x, win_y)
        for name, (wrapper, knob) in hist_ab.VARIANTS.items():
            counts = wrapper(lx, ly, win_x, win_y, **knob)
            torch.cuda.synchronize()
            worst = max(worst, int((counts - plain).abs().max()))
            if not (torch.equal(counts, plain) and torch.equal(counts, b1)):
                raise AssertionError(f"B7 {name} differs from its plain version or B1: {label}")
        print(f"B7 check {label}: N={lx.shape[0]}, every variant equal to the plain version"
              f" and to B1's count mode (mass {int(plain.sum())})")

    hist_ab.hist_onehot.launches = hist_ab.hist_twolevel.launches = 0
    records = hist_ab.main(["--particles", str(N_PARTICLES), "--win", f"{win_x},{win_y}"])
    launched = {"onehot": hist_ab.hist_onehot.launches,
                "twolevel": hist_ab.hist_twolevel.launches}
    if min(launched.values()) < 1:
        raise AssertionError(f"B7: the harness did not launch both kernels: {launched}")
    by_name = {r["variant"]: r for r in records}
    lx, ly = cases["harness spot"]
    plain_ms = cuda_ms(lambda: hist_ab.hist_ab_reference(lx, ly, win_x, win_y),
                         iters=50)
    plain_device = device_ms(lambda: hist_ab.hist_ab_reference(lx, ly, win_x, win_y), iters=20)
    timing = {}
    for kernel in ("onehot", "twolevel"):
        best = min((r for r in records if r["variant"].startswith(kernel)),
                   key=lambda r: r["device_ms"])
        timing[kernel] = dict(
            ms=best["ms_per_read"], device_ms=best["device_ms"], variant=best["variant"],
            plain_ms=plain_ms, bound=hist_bound(N_PARTICLES, WINDOW),
            library_ms=by_name["torch.bincount"]["ms_per_read"],
        )
        t = timing[kernel]
        floor = (f"; the onehot read's own int8 operations"
                 f" {onehot_floor(torch, lx, ly, WINDOW):.5f} ms" if kernel == "onehot" else
                 f"; previous design (28-row bands) {PARENT_DEVICE_MS['B7 twolevel']:.5f} ms of"
                 f" device time (PERF.md)")
        main_kernel = "contraction" if kernel == "onehot" else "cluster kernel"
        print(f"B7 {kernel} at the harness's shape (N={N_PARTICLES}, window {WINDOW}): fastest"
              f" variant by device time {t['variant']} {t['ms']:.5f} ms per read (CUDA events,"
              f" 200 reads),"
              f" device {t['device_ms']:.5f} ms summed over every kernel of the read, of it the"
              f" {main_kernel} {best['kernel_ms']:.5f} ms (torch.profiler); plain"
              f" {plain_ms:.4f} ms,"
              f" device {plain_device:.5f} ms; bound {t['bound'][0]:.5f} ms ({t['bound'][1]})"
              f"{floor}; B1's count mode {by_name['B1 window_histogram']['ms_per_read']:.5f} ms,"
              f" device {by_name['B1 window_histogram']['device_ms']:.5f} ms (its kernel"
              f" {by_name['B1 window_histogram']['kernel_ms']:.5f} ms); torch.bincount"
              f" {t['library_ms']:.5f} ms, device {by_name['torch.bincount']['device_ms']:.5f} ms;"
              f" card {card}")
    for record in records:
        if record["variant"].startswith(("onehot", "twolevel")):
            print(f"B7 {record['variant']}: {record['ms_per_read']:.5f} ms per read, device"
                  f" {record['device_ms']:.5f} ms, of it the main kernel"
                  f" {record['kernel_ms']:.5f} ms")
    return launched, timing, float(worst)


# -- path O, optimize_speed; path M, the parallel layer --------------------------

OPTIMIZE_CELLS, OPTIMIZE_BATCH = 150, 1000  # the example's fodo_lattice(150) at 1000 settings
# Calls timed a stage: stage 1 takes ~1.4 s a track on the card (1058 maps
# built on the host), so fewer than the example's 20.
OPTIMIZE_ITERS = 3
TRAIN_MESH_STEPS = 10  # path M (b): path T's steps
# The env's tuned magnets and their limits (k1 in 1/m^2, angles in rad).
TUNED_MAGNETS = {"AREAMQZM1": ("k1", 30.0), "AREAMQZM2": ("k1", 30.0),
                 "AREAMQZM3": ("k1", 30.0), "AREAMCVM1": ("angle", 6e-3),
                 "AREAMCHM1": ("angle", 6e-3)}


def nccl_kernels(launches):
    """The NCCL kernels among ``device_launches``' names, and their count."""
    names = {name: count for name, count in launches.items() if "nccl" in name.lower()}
    return sum(names.values()), sorted(names)


@contextlib.contextmanager
def sweep_route(segment_module, fused, threshold=None):
    """Force the ParameterBeam runs' route: the fused sweep (B3/B4) from
    ``threshold`` settings, or the dense route."""
    saved = segment_module.FUSED_SWEEP_PATH, segment_module.PALLAS_SWEEP_THRESHOLD
    segment_module.FUSED_SWEEP_PATH = fused
    if threshold is not None:
        segment_module.PALLAS_SWEEP_THRESHOLD = threshold
    try:
        yield
    finally:
        segment_module.FUSED_SWEEP_PATH, segment_module.PALLAS_SWEEP_THRESHOLD = saved


def path_optimize_speed(torch, ltt, ft, hist, segment_module, optimize_speed, card):
    """Path O: the optimize_speed example at its own sizes (1058 elements,
    stage 4 at B = 1000, the dense route below PALLAS_SWEEP_THRESHOLD), then
    the merged lattice at B = 1000 through B3 (the fused route forced, its
    threshold lowered to B), held against the dense route in double;
    tracks/s of both.  Returns the launches and the stages' results (J13
    holds its replays to them)."""
    reset_counts(ft, hist)
    results = optimize_speed.main(OPTIMIZE_CELLS, OPTIMIZE_BATCH, device="cuda",
                                  iters=OPTIMIZE_ITERS, graph=False)
    torch.cuda.synchronize()
    stage_launches = counts(ft)
    for label, seconds, outgoing, _ in results:
        if not bool(torch.isfinite(outgoing._mu).all()):
            raise AssertionError(f"path O: {label}: non-finite moments")
    print(f"path O: {', '.join(f'{label} {seconds * 1e3:.4f} ms' for label, seconds, *_ in results)}"
          f" per track (CUDA events, profiling.benchmark, {OPTIMIZE_ITERS} calls); launches"
          f" {stage_launches} (stage 4 at B={OPTIMIZE_BATCH} < PALLAS_SWEEP_THRESHOLD"
          f" {segment_module.PALLAS_SWEEP_THRESHOLD}: the dense route); card {card}")
    if any(stage_launches.values()):
        raise AssertionError("path O: a kernel launched on the dense route")

    lattice = optimize_speed.build_lattice(OPTIMIZE_CELLS, device="cuda")
    beam = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]), energy=torch.tensor([1e8]), device="cuda")
    _, merged, batched_beam = optimize_speed.stages(lattice, beam, OPTIMIZE_BATCH)[3]

    def track():
        return merged.track(batched_beam)

    with sweep_route(segment_module, True, OPTIMIZE_BATCH):
        reset_counts(ft, hist)
        with plain_on_cuda_guard(torch, ft) as plain:
            fused = track()
            torch.cuda.synchronize()
        launched = counts(ft)
        fused_ms = cuda_ms(track, iters=20)
        device, b3 = device_ms(track, iters=5, kernel="moment_sweep_kernel")
    if launched["B3"] != 1 or plain["count"]:
        raise AssertionError("path O: the forced fused route did not run through kernel B3")
    with sweep_route(segment_module, False):
        dense_ms = cuda_ms(track, iters=20)
        dense = merged.to(torch.float64).track(type(batched_beam)(
            batched_beam._mu.double(), batched_beam._cov.double(), batched_beam.energy.double()))
    error = max(relative_error(torch, getattr(fused, stat), getattr(dense, stat), per_setting=False)
                for stat in ("mu_x", "sigma_x", "mu_y", "sigma_y"))
    print(f"path O: the merged lattice ({len(merged.elements)} element) at B={OPTIMIZE_BATCH}:"
          f" B3 (fused route forced) {fused_ms:.4f} ms a track"
          f" ({OPTIMIZE_BATCH * 1000.0 / fused_ms:.1f} tracks/s), the dense route {dense_ms:.4f}"
          f" ms ({OPTIMIZE_BATCH * 1000.0 / dense_ms:.1f} tracks/s) (CUDA events, 20 calls); B3's"
          f" device time {b3:.5f} ms of the call's {device:.5f} ms (torch.profiler, 5 calls); B3"
          f" (float) against the dense route in double {error:.2e} of each moment's largest"
          f" |value| (bound {OBS_RTOL}); launches {launched}; card {card}")
    if error > OBS_RTOL:
        raise AssertionError("path O: B3 and the dense route disagree")
    return launched, results


def compare_parallel(torch, ft, hist, label, unsharded, sharded, mesh, card):
    """Run ``unsharded()`` and, inside ``with mesh:``, ``sharded()`` with the
    launch counts set to 0 before each; both runs' B1-B6 launches must be
    equal.  For the sharded call, the collectives the layer issues (its own
    count) and the NCCL kernels among the profiler's kernel names are
    printed; both calls are timed in turns (unsharded, sharded, sharded,
    unsharded; CUDA events).  Returns (unsharded result, sharded result,
    the sharded run's launches)."""
    from lynx_tpu_torch import _collectives

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        expected = unsharded()
        torch.cuda.synchronize()
    alone = counts(ft)
    alone["B1"] = hist.window_histogram.launches
    with mesh:
        reset_counts(ft, hist)
        issued = _collectives.counts["all_reduce"]
        with plain_on_cuda_guard(torch, ft) as plain_sharded:
            actual = sharded()
            torch.cuda.synchronize()
        issued = _collectives.counts["all_reduce"] - issued
        launched = counts(ft)
        launched["B1"] = hist.window_histogram.launches
        nccl, names = nccl_kernels(device_launches(sharded))
    times = {"unsharded": [cuda_ms(unsharded, iters=5)]}
    with mesh:
        times["sharded"] = [cuda_ms(sharded, iters=5) for _ in range(2)]
    times["unsharded"].append(cuda_ms(unsharded, iters=5))
    sharded_ms, unsharded_ms = (sum(t) / 2 for t in (times["sharded"], times["unsharded"]))
    print(f"path M ({label}): launches through the parallel layer {launched}, unsharded {alone};"
          f" all-reduces issued by the layer {issued}, NCCL kernels {nccl}"
          f" ({', '.join(names) or 'none'}; torch.profiler); {sharded_ms:.4f} ms a call through"
          f" the parallel layer ({', '.join(f'{t:.4f}' for t in times['sharded'])}) against"
          f" {unsharded_ms:.4f} ms unsharded ({', '.join(f'{t:.4f}' for t in times['unsharded'])})"
          f" (CUDA events, 5 calls a turn, in turns; card {card})")
    if launched != alone or plain["count"] or plain_sharded["count"]:
        raise AssertionError(f"path M ({label}): the kernels' launches differ from the unsharded call's")
    return expected, actual, launched


def path_parallel(torch, ltt, ares, ft, hist, fused, functional, tuning, parallel,
                  multichip_tuning, seg1, beam1, card):
    """Path M: the parallel layer in a one-rank NCCL world on a 1 x 1
    (batch, particles) mesh, at full width: (a) the flagship read of a
    100,000-particle beam through shard_beam under the particle context
    (B1); (a') path P's 100 x 10,000 push through shard_beam (B2); (b)
    make_tuning_train_step over the env's subcell at 100,000 settings for 10
    Adam steps (B3, B4), held to the unsharded tuner; (c) the
    settings-sharded particle moment sweep at path A's B = 256 (B6); (d)
    pipeline_track with one stage; (e) the multichip_tuning example.  Each
    runs eagerly (``graph=False`` where the call has a graph form); path J's
    J11 replays them.  Returns the launches and what J11 reuses; the world
    stays up for J11."""
    parallel.initialize(device_type="cuda")
    mesh = parallel.make_mesh(device_type="cuda")
    print(f"path M: world of {parallel.process_count()} rank (NCCL), mesh {mesh.shape} on"
          f" {mesh.device}; card {card}")
    launches = {}

    # (a) the flagship read, its particle axis through shard_beam.
    def read(beam):
        return functional.track(seg1, beam)[1]["AREABSCR1"]

    image, sharded_image, launched = compare_parallel(
        torch, ft, hist, "a, the flagship read", lambda: read(beam1),
        lambda: read(parallel.shard_beam(beam1, mesh)), mesh, card)
    if launched["B1"] != hist.READ_LAUNCHES or not torch.equal(image, sharded_image):
        raise AssertionError("path M (a): the sharded read differs from the unsharded one")
    launches["B1"] = launched["B1"]

    # (a') path P's push, beam and segment through the parallel layer.
    segment, beam, _ = push_path_beam(torch, ares, ltt.ParticleBeam, PUSH_BATCH, PUSH_PARTICLES,
                                      seed=43)
    with torch.no_grad():
        pushed, sharded_pushed, launched = compare_parallel(
            torch, ft, hist, "a', the push", lambda: segment.track(beam).particles,
            lambda: parallel.shard_segment(segment, mesh).track(
                parallel.shard_beam(beam, mesh)).particles, mesh, card)
    if launched["B2"] != 1 or not torch.equal(pushed, sharded_pushed):
        raise AssertionError("path M (a'): the sharded push differs from the unsharded one")
    launches["B2"] = launched["B2"]

    # (b) the train step at path S's width against the unsharded tuner.
    B = SWEEP_BATCH
    gen = torch.Generator(device="cuda").manual_seed(51)

    settings = {name: (torch.rand(B, generator=gen, device="cuda") - 0.5) * limit
                for name, (_, limit) in TUNED_MAGNETS.items()}

    def subcell():
        segment = ares.ares_ea_segment(device="cuda")
        segment.AREABSCR1.is_active = False
        for name, (field, _) in TUNED_MAGNETS.items():
            setattr(getattr(segment, name), field, settings[name].clone())
        return segment
    target = torch.rand((B, 4), generator=gen, device="cuda") * 1e-4
    nominal = ltt.ParameterBeam.from_parameters(
        sigma_x=torch.tensor([1.75e-4]), sigma_y=torch.tensor([1.75e-4]),
        sigma_xp=torch.tensor([2e-5]), sigma_yp=torch.tensor([2e-5]),
        energy=torch.tensor([1.073e8]), device="cuda")
    train_beam = ltt.ParameterBeam(nominal._mu.expand(B, 7).contiguous(),
                                   nominal._cov.expand(B, 7, 7).contiguous(), nominal.energy)

    def loss_fn(segment, beam):
        out, _ = functional.track(segment, beam)
        observed = torch.stack([out.mu_x, out.sigma_x, out.mu_y, out.sigma_y], dim=-1)
        return torch.mean(torch.abs(observed - target)) * 1e3

    def tuned(segment):
        return [getattr(getattr(segment, name), field).requires_grad_(True)
                for name, (field, _) in TUNED_MAGNETS.items()]

    def adam(segment):
        # One step size per kind: k1 (O(10) 1/m^2), angles (O(1e-3) rad).
        return torch.optim.Adam([
            {"params": [getattr(segment, name).k1 for name in TUNED_MAGNETS
                        if TUNED_MAGNETS[name][0] == "k1"], "lr": 5e-2},
            {"params": [getattr(segment, name).angle for name in TUNED_MAGNETS
                        if TUNED_MAGNETS[name][0] == "angle"], "lr": 5e-5},
        ])

    def unsharded():
        segment = subcell()
        tuned(segment)
        optimizer = adam(segment)
        tuner = tuning.make_tuner(optimizer, loss_fn, graph=False)  # as the sharded step runs
        _, losses = tuner(segment, TRAIN_MESH_STEPS, train_beam)
        return losses, tuned(segment)

    def sharded():
        segment = parallel.shard_segment(subcell(), mesh)
        tuned(segment)
        optimizer = adam(segment)
        step = parallel.make_tuning_train_step(optimizer, loss_fn, graph=False)  # eager: J11
        losses = []
        for _ in range(TRAIN_MESH_STEPS):
            segment, loss = step(segment, parallel.shard_beam(train_beam, mesh))
            losses.append(loss)
        return torch.stack(losses), tuned(segment)

    (losses, params), (sharded_losses, sharded_params), launched = compare_parallel(
        torch, ft, hist, "b, the train step", unsharded, sharded, mesh, card)
    loss_error = relative_error(torch, sharded_losses, losses, per_setting=False)
    setting_error = max(relative_error(torch, a.detach(), b.detach(), per_setting=False)
                        for a, b in zip(sharded_params, params))
    print(f"path M (b): {TRAIN_MESH_STEPS} Adam steps at B={B}: loss {float(losses[0]):.6e} ->"
          f" {float(losses[-1]):.6e}; through the parallel layer against the unsharded tuner:"
          f" losses {loss_error:.2e}, final settings {setting_error:.2e} of the largest |value|"
          f" (bounds {OBS_RTOL}, {GRAD_RTOL}: path T's)")
    if launched["B3"] != TRAIN_MESH_STEPS or launched["B4"] != TRAIN_MESH_STEPS:
        raise AssertionError("path M (b): the train step did not run through kernels B3 and B4")
    if loss_error > OBS_RTOL or setting_error > GRAD_RTOL or not losses[-1] < losses[0]:
        raise AssertionError("path M (b): the sharded train step differs from the tuner")
    launches["B3"], launches["B4"] = launched["B3"], launched["B4"]

    # (c) the settings-sharded particle moment sweep at path A's B = 256.
    B = APERTURE_BATCHES[-1]
    particles = moment_cloud(torch, ltt.ParticleBeam, MOMENT_PARTICLES, seed=92).particles[0]
    weights = torch.ones(MOMENT_PARTICLES, device="cuda")
    elements = aperture_lattice(torch, ltt, B, "rect", torch.float32)
    entries, scalars = plan_of(torch, fused, elements, B, torch.float32)
    local_slice = parallel.sharding.local_slice

    with torch.no_grad():
        moments, sharded_moments, launched = compare_parallel(
            torch, ft, hist, "c, the settings-sharded sweep",
            lambda: ft.sweep_particle_moments(entries, scalars, particles, weights),
            lambda: ft.sweep_particle_moments(
                entries, tuple(local_slice(s, mesh, "batch") for s in scalars), particles,
                weights),
            mesh, card)
    if launched["B6"] != 1 or not all(torch.equal(a, b) for a, b in zip(moments, sharded_moments)):
        raise AssertionError("path M (c): the settings-sharded sweep differs from the unsharded")
    launches["B6"] = launched["B6"]

    # (d) pipeline_track with one stage against functional.track.
    pipe_mesh = parallel.make_pipeline_mesh(1, device_type="cuda")
    segment = ares.ares_ea_segment(device="cuda")
    segment.AREABSCR1.is_active = False
    pipe_beam = ltt.ParameterBeam(train_beam._mu[:1024], train_beam._cov[:1024],
                                  train_beam.energy.expand(1024).contiguous())
    expected, _ = functional.track(segment, pipe_beam)
    out = parallel.pipeline_track(parallel.split_into_stages(segment, 1), pipe_beam, pipe_mesh, 4,
                                  graph=False)
    error = max(relative_error(torch, getattr(out, stat), getattr(expected, stat))
                for stat in ("_mu", "_cov"))
    print(f"path M (d): pipeline_track, 1 stage, 4 microbatches of 256: against functional.track"
          f" {error:.2e} per setting (bound {FLOAT_RTOL['B3']})")
    if error > FLOAT_RTOL["B3"]:
        raise AssertionError("path M (d): the pipeline differs from functional.track")

    # (e) the multichip_tuning example at its own sizes, in this world.
    start = time.perf_counter()
    result = multichip_tuning.main(steps=30, device="cuda", graph=False)
    seconds = time.perf_counter() - start
    tuner_error = relative_error(torch, torch.tensor(result["tuner_losses"]),
                                 torch.tensor(result["losses"]), per_setting=False)
    print(f"path M (e): multichip_tuning on mesh {result['mesh']}: loss {result['losses'][0]:.4e}"
          f" -> {result['losses'][-1]:.4e} over 30 steps; the tuner's losses against the loop's"
          f" {tuner_error:.2e} (bound {OBS_RTOL}); {seconds:.2f} s (host clock; card {card})")
    if not result["losses"][-1] < result["losses"][0] or tuner_error > OBS_RTOL:
        raise AssertionError("path M (e): the example did not tune, or its two loops disagree")
    # The world stays up for J11, which main() ends with.
    return launches, dict(mesh=mesh, subcell=subcell, tuned=tuned, adam=adam, loss_fn=loss_fn,
                          beam=train_beam, losses=losses, params=params, pipe_beam=pipe_beam,
                          pipe_mesh=pipe_mesh, example=result)


# -- path V: random element mixes on kernels B1-B6 ------------------------------

# The random-lattice generator of tests/test_random_lattices.py
# (``_random_element``): each element's kind drawn from RANDOM_KINDS, then its
# parameters from their ranges, all from one random.Random(seed) in the same
# order, so that seed s gives the JAX suite's lattice of s
# (tests/test_torch_random_lattices.py holds this copy to the JAX one).  Path
# V runs seeds 0-15 at 8 to 24 elements.
RANDOM_KINDS = ("drift", "quad", "dipole", "hcor", "vcor", "solenoid", "undulator", "cavity",
                "marker")
RANDOM_SEEDS = tuple(range(16))
# The fields path V draws per setting, in the generator's own ranges:
# every magnet's, corrector's and cavity's parameters (lengths stay fixed).
RANDOM_FIELDS = {
    "Quadrupole": {"k1": (-30.0, 30.0), "tilt": (-0.1, 0.1)},
    "Dipole": {"angle": (-0.1, 0.1), "e1": (-0.02, 0.02), "e2": (-0.02, 0.02)},
    "HorizontalCorrector": {"angle": (-5e-3, 5e-3)},
    "VerticalCorrector": {"angle": (-5e-3, 5e-3)},
    "Solenoid": {"k": (0.0, 5.0)},
    "Cavity": {"voltage": (0.0, 2e6), "phase": (-30.0, 30.0)},
}
# The random lattices' nominal beam (tests/test_random_lattices.py's BEAM_PARAMS).
RANDOM_BEAM = dict(mu_x=1e-5, mu_xp=2e-6, mu_y=-2e-5, mu_yp=-1e-6, sigma_x=1.75e-4,
                   sigma_xp=2e-5, sigma_y=1.75e-4, sigma_yp=2e-5, sigma_s=8e-6, sigma_p=2e-3,
                   energy=1e8)
V_SLICE = 1024  # V2: the settings held against the CPU's plain B3/B4
# V2's gradients.  The fields' units differ (a cavity's d/dvoltage is ~1e-12
# of a corrector's d/dangle), so each is held on a scale of its own kind.
# Against the plain B3/B4 (the slice, run on the CPU and on the card): each
# field relative to its own largest |value|, as ``cotangent_errors`` holds
# B4's, at FIELD_RTOL.  d/dvoltage and a dipole's d/dangle near angle 0 are
# ill-conditioned in float64 (small differences of large terms, which an
# ulp in the cotangents of the maps around them moves), so the plain
# version differs from itself by up to 1.0e-10 of a field's largest between
# the CPU and the card (seed 3's d/dvoltage; NVIDIA H100 80GB HBM3, 700 W:
# PERF.md, path V); FIELD_RTOL is SPREAD_FACTOR times that, and the run
# prints that spread beside each field's reading.  Against the dense
# route (every setting): each field's cotangent times its range in
# RANDOM_FIELDS (the loss's change over that range), relative to the
# setting's largest such change, at ROUTE_RTOL: B4's dual numbers through
# the table builders and autograd of the dense matrices cancel differently
# near a zero strength (a cavity at a few kV, a dipole at a few urad).
ROUTE_RTOL = 100 * DOUBLE_RTOL
FIELD_RTOL = 1e-9
V_PUSH_BATCH, V_PUSH_PARTICLES = 32, 10_000  # V3
V_MOMENT_BATCHES = (8, 256)  # V4: B5 below _PACK_SETTINGS, B6 above
V_APERTURE_SIGMAS = 1.5  # V4: the aperture's half-widths, |mu| + this many sigma
V_READ_BATCH = 8  # V5: the flagship's B = 8
V_READ_HALF_SIGMAS = 12.0  # V5: the screen's half-extent beyond the spots, in sigma
V_READ_K_SIGMA = 6.0  # V5: the window, Screen.derive_histogram_window's default
# V1: the JAX suite's pinned tracks (tests/test_golden_tracking.py) and its
# tolerances; through the dense route at B = 1 and through B2 at its fewest
# settings.
GOLDEN = RESOURCES / "golden_tracking.npz"
GOLDEN_RTOL, GOLDEN_ATOL, GOLDEN_ENERGY_RTOL = 1e-12, 1e-18, 1e-14
GOLDEN_PUSH_BATCH = 16


def random_length(seed):
    """Elements of path V's lattice of ``seed``: 8 at seed 0 to 24 at seed 15."""
    return 8 + 16 * seed // 15


def random_lattice(torch, ltt, seed, n_elements, dtype=None, device="cuda"):
    """tests/test_random_lattices.py's ``_random_segment(seed, n_elements)``
    built on the port, float64 unless ``dtype`` says otherwise."""
    import random

    rng = random.Random(seed)
    kw = dict(dtype=torch.float64 if dtype is None else dtype, device=device)

    def a(value):
        return torch.tensor([value], **kw)

    elements = []
    for index in range(n_elements):
        kind = rng.choice(RANDOM_KINDS)
        name = f"{kind}_{index}"
        if kind == "drift":
            element = ltt.Drift(length=a(rng.uniform(0.05, 1.0)), name=name, **kw)
        elif kind == "quad":
            element = ltt.Quadrupole(length=a(rng.uniform(0.05, 0.3)),
                                     k1=a(rng.uniform(-30.0, 30.0)),
                                     tilt=a(rng.uniform(-0.1, 0.1)), name=name, **kw)
        elif kind == "dipole":
            element = ltt.Dipole(length=a(rng.uniform(0.1, 0.5)), angle=a(rng.uniform(-0.1, 0.1)),
                                 e1=a(rng.uniform(-0.02, 0.02)), e2=a(rng.uniform(-0.02, 0.02)),
                                 name=name, **kw)
        elif kind in ("hcor", "vcor"):
            corrector = ltt.HorizontalCorrector if kind == "hcor" else ltt.VerticalCorrector
            element = corrector(length=a(rng.uniform(0.01, 0.1)),
                                angle=a(rng.uniform(-5e-3, 5e-3)), name=name, **kw)
        elif kind == "solenoid":
            element = ltt.Solenoid(length=a(rng.uniform(0.1, 0.5)), k=a(rng.uniform(0.0, 5.0)),
                                   name=name, **kw)
        elif kind == "undulator":
            element = ltt.Undulator(length=a(rng.uniform(0.1, 0.5)), name=name, **kw)
        elif kind == "cavity":
            element = ltt.Cavity(length=a(rng.uniform(0.5, 1.5)),
                                 voltage=a(rng.uniform(0.0, 2e6)),
                                 phase=a(rng.uniform(-30.0, 30.0)), frequency=a(2.998e9),
                                 name=name, **kw)
        else:
            element = ltt.Marker(name=name, **kw)
        elements.append(element)
    return ltt.Segment(elements, name=f"fuzz_{seed}")


def random_settings(torch, lattice, B, seed, cavities=True):
    """``{(element index, field): (B,) float64 host tensor}``: per-setting
    values of RANDOM_FIELDS, drawn on the host from one seed (the same on
    any device).  Without ``cavities`` every cavity's voltage is 0 (the
    cavity then is a skippable, affine element); its phase is still drawn."""
    gen = torch.Generator().manual_seed(seed)
    settings = {}
    for index, element in enumerate(lattice.elements):
        for field, (low, high) in RANDOM_FIELDS.get(type(element).__name__, {}).items():
            value = low + (high - low) * torch.rand(B, generator=gen, dtype=torch.float64)
            settings[index, field] = torch.zeros_like(value) if (
                field == "voltage" and not cavities) else value
    return settings


def apply_settings(lattice, settings, rows=slice(None), requires_grad=False):
    """Set the lattice's fields to rows ``rows`` of ``settings``, in each
    field's dtype and on its device; returns the new tensors."""
    tensors = []
    for (index, field), value in settings.items():
        old = getattr(lattice.elements[index], field)
        new = value[rows].to(dtype=old.dtype, device=old.device).requires_grad_(requires_grad)
        setattr(lattice.elements[index], field, new)
        tensors.append(new)
    return tensors


def random_parameter_beam(torch, ltt, B, device, dtype=None):
    """B settings of the nominal ParameterBeam: moments (B, ...), energy (1,)."""
    dtype = torch.float64 if dtype is None else dtype
    nominal = ltt.ParameterBeam.from_parameters(
        **{key: torch.tensor([value]) for key, value in RANDOM_BEAM.items()}, dtype=dtype,
        device=device)
    return ltt.ParameterBeam(nominal._mu.expand(B, 7).contiguous(),
                             nominal._cov.expand(B, 7, 7).contiguous(), nominal.energy)


def random_particle_beam(torch, ltt, B, n, seed, device, dtype=None):
    """One cloud of ``n`` particles sampled from the nominal beam, tiled to B settings."""
    dtype = torch.float64 if dtype is None else dtype
    cloud = ltt.ParticleBeam.from_parameters(
        num_particles=n, **{key: torch.tensor([value]) for key, value in RANDOM_BEAM.items()},
        generator=torch.Generator(device=device).manual_seed(seed), dtype=dtype, device=device)
    tiled = cloud.broadcast((B,))
    return ltt.ParticleBeam(tiled.particles.contiguous(), tiled.energy.contiguous(),
                            particle_charges=tiled.particle_charges.contiguous())


def skippable_runs(elements):
    """The maximal runs of skippable elements between the others."""
    runs, run = [], []
    for element in elements:
        if element.is_skippable:
            run.append(element)
        elif run:
            runs.append(run)
            run = []
    return runs + ([run] if run else [])


def sweep_launches(torch, fused, lattice, beam):
    """``(B3, B4)``: the launches of ``functional.track`` of the ParameterBeam
    ``beam`` through ``lattice`` and its backward, from the planner: one B3
    a run whose plan (``fused.plan_run`` at the energy the beam carries
    there) is not empty, one B4 a such run with an input that requires grad
    (a value of its plan, or the beam it takes in).  The elements between
    the runs are tracked to carry the energy."""
    b3 = b4 = 0
    grad = any(t.requires_grad for t in (beam._mu, beam._cov, torch.as_tensor(beam.energy)))
    run = []
    for element in [*lattice.flattened().elements, None]:
        if element is not None and element.is_skippable:
            run.append(element)
            continue
        if run:
            energy = torch.as_tensor(beam.energy)
            B = beam._mu.shape[0]
            plan = fused.plan_run([fused.element_map_builder(e) for e in run], energy,
                                  lambda x: torch.broadcast_to(x, (B,)).reshape(B))
            values = [v for _, _, vs in plan for v in vs]
            if plan:
                grad = grad or any(v.requires_grad for v in values)
                b3, b4 = b3 + 1, b4 + int(grad)
            run = []
        if element is not None:
            beam = element.track(beam)
            grad = grad or any(t.requires_grad for t in (
                beam._mu, beam._cov, torch.as_tensor(beam.energy)))
    return b3, b4


def kinds_of(lattices):
    """Each lattice's element kinds, by seed: the JSON lines' record of the mixes."""
    return {str(seed): [type(e).__name__ for e in lattice.elements]
            for seed, lattice in lattices.items()}


def path_v_golden(torch, ltt, ft, hist, card):
    """V1: the four pinned lattices of tests/test_golden_tracking.py on the
    card, float64: through the dense route at B = 1, and tiled to
    GOLDEN_PUSH_BATCH settings through B2 (Segment.track's per-setting
    push), each setting held to the file."""
    import numpy as np

    golden = np.load(GOLDEN)
    beam = golden_beam(torch, ltt, "cuda")
    incoming = relative_golden(torch, beam.particles, golden["incoming_particles"])
    worst = {"dense": 0.0, "B2": 0.0, "energy": 0.0}
    segments = golden_segments(torch, ltt, "cuda")
    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        for name, elements in segments.items():
            segment = ltt.Segment(elements)
            want = golden[f"{name}_particles"]
            dense = segment.track(beam)  # B = 1: below the push's 16 settings
            tiled = beam.broadcast((GOLDEN_PUSH_BATCH,))
            pushed = segment.track(ltt.ParticleBeam(tiled.particles.contiguous(),
                                                    tiled.energy.contiguous()))
            worst["dense"] = max(worst["dense"], relative_golden(torch, dense.particles, want))
            worst["B2"] = max(worst["B2"], relative_golden(
                torch, pushed.particles, np.broadcast_to(want, (GOLDEN_PUSH_BATCH, *want.shape[1:]))))
            for out in (dense, pushed):
                energy = out.energy.detach().double().cpu().numpy()
                expected = golden[f"{name}_energy"]
                worst["energy"] = max(worst["energy"], float(np.max(
                    np.abs(energy - expected) / np.abs(expected))))
        torch.cuda.synchronize()
    launched = counts(ft)
    line = {"path": "V1", "what": "tests/resources/golden_tracking.npz's four lattices, dense"
            f" route at B=1 and B2 at B={GOLDEN_PUSH_BATCH}, float64",
            "lattices": {name: [type(e).__name__ for e in elements]
                         for name, elements in segments.items()},
            "launches": {"B2": launched["B2"]}, "plain_on_cuda": plain["count"],
            "max_err": {"incoming": incoming, **worst},
            "bounds": {"particles": f"rtol {GOLDEN_RTOL}, atol {GOLDEN_ATOL}",
                       "energy": f"rtol {GOLDEN_ENERGY_RTOL}"},
            "card": card}
    print(json.dumps(line))
    runs = sum(len(skippable_runs(elements)) for elements in segments.values())
    if launched["B2"] != runs or plain["count"]:
        raise AssertionError("V1: a golden lattice did not go through kernel B2")
    if max(incoming, worst["dense"], worst["B2"]) > 1 or worst["energy"] > GOLDEN_ENERGY_RTOL:
        raise AssertionError("V1: the card's tracks leave the golden file's tolerances")
    return launched["B2"]


def relative_golden(torch, actual, expected):
    """The worst |actual - expected| in units of the golden tolerance
    (GOLDEN_ATOL + GOLDEN_RTOL |expected|): at most 1 passes."""
    import numpy as np

    actual = actual.detach().double().cpu().numpy()
    return float(np.max(np.abs(actual - expected) / (GOLDEN_ATOL + GOLDEN_RTOL * np.abs(expected))))


def golden_beam(torch, ltt, device):
    """tests/test_golden_tracking.py's linspaced float64 beam of 32 particles."""
    f64 = torch.float64

    def t(value):
        return torch.tensor([value], dtype=f64)

    return ltt.ParticleBeam.make_linspaced(
        num_particles=32, mu_x=t(1e-4), mu_xp=t(-2e-5), mu_y=t(-5e-5), mu_yp=t(1e-5),
        sigma_x=t(2e-4), sigma_xp=t(3e-5), sigma_y=t(1.5e-4), sigma_yp=t(2.5e-5),
        sigma_s=t(1e-5), sigma_p=t(2e-3), energy=t(1.2e8), dtype=f64, device=device)


def golden_segments(torch, ltt, device):
    """tests/test_golden_tracking.py's four lattices, float64 on ``device``."""
    kw = dict(dtype=torch.float64, device=device)

    def t(value):
        return torch.tensor([value], **kw)

    return {
        "dqd": [ltt.Drift(t(0.5), **kw), ltt.Quadrupole(t(0.23), k1=t(4.2), tilt=t(0.1), **kw),
                ltt.Drift(t(0.5), **kw)],
        "bend_line": [
            ltt.Dipole(t(0.31), angle=t(0.12), e1=t(0.05), e2=t(0.03), fringe_integral=t(0.4),
                       gap=t(0.05), tilt=t(0.2), **kw),
            ltt.Drift(t(0.4), **kw),
            ltt.RBend(t(0.25), angle=t(-0.08), **kw)],
        "sol_und_corr": [
            ltt.Solenoid(t(0.4), k=t(1.3), misalignment=torch.tensor([[1e-4, -2e-4]], **kw), **kw),
            ltt.Undulator(t(0.35), **kw),
            ltt.HorizontalCorrector(t(0.1), angle=t(3e-4), **kw),
            ltt.VerticalCorrector(t(0.1), angle=t(-2e-4), **kw)],
        "cavity_line": [
            ltt.Drift(t(0.2), **kw),
            ltt.Cavity(t(1.0377), voltage=t(1.815975e7), phase=t(-12.0), frequency=t(1.3e9),
                       **kw),
            ltt.Drift(t(0.2), **kw)],
    }


def random_sweep_loss(torch, outgoing):
    return torch.sum(outgoing.sigma_x + outgoing.sigma_y + outgoing.mu_x + outgoing.mu_y)


def random_sweep(torch, ltt, functional, seed, B, device, rows=slice(None), settings=None):
    """Seed ``seed``'s lattice on ``device`` at ``B`` settings (rows
    ``rows`` of ``settings`` if given): the tracked ParameterBeam, the
    tuned tensors and their gradients of ``random_sweep_loss``."""
    lattice = random_lattice(torch, ltt, seed, random_length(seed), device=device)
    if settings is None:
        settings = random_settings(torch, lattice, B, seed)
    tuned = apply_settings(lattice, settings, rows, requires_grad=True)
    outgoing, _ = functional.track(lattice, random_parameter_beam(torch, ltt, B, device))
    grads = torch.autograd.grad(random_sweep_loss(torch, outgoing), tuned)
    return lattice, settings, outgoing, tuned, grads


def gradient_errors(torch, lattice, grads, expected, tuned, settings):
    """``(common, own, worst d/dk1 at |k1| < K1_SMALL)``, each tuned field's
    gradient against ``expected`` as ``{(index, field): error}`` on V2's two
    scales: ``common`` its error times the field's range in RANDOM_FIELDS,
    relative to the setting's largest |expected| times range over its
    fields; ``own`` relative to the field's largest |expected|.  d/dk1
    entries at |k1| < K1_SMALL are held apart (relative to the entry)."""
    errors, scaled, own, small_worst = {}, [], {}, 0.0
    for key, g, e, t in zip(settings, grads, expected, tuned):
        g, e = g.detach().double(), e.detach().double().to(g.device)
        error = (g - e).abs()
        if key[1] == "k1":
            small = t.detach().abs().to(g.device) < K1_SMALL
            if bool(small.any()):
                small_worst = max(small_worst, float(
                    (error[small] / e.abs()[small].clamp_min(1e-300)).max()))
            error = torch.where(small, 0.0, error)
            e = torch.where(small, 0.0, e)
        low, high = RANDOM_FIELDS[type(lattice.elements[key[0]]).__name__][key[1]]
        own[key] = float(error.max() / e.abs().max().clamp_min(1e-300))
        errors[key] = error * (high - low)
        scaled.append(e.abs() * (high - low))
    if not scaled:
        return {}, {}, small_worst
    scale = torch.stack(scaled).amax(dim=0).clamp_min(1e-300)
    common = {key: float((error / scale).max()) for key, error in errors.items()}
    return common, own, small_worst


def slice_sweep(torch, ltt, ft, functional, segment_module, seed, settings, device):
    """The first V_SLICE settings of ``settings`` through the plain B3/B4 on
    ``device`` (``random_sweep``'s outputs): on the card the wrappers take
    the plain versions for the call."""
    saved = {name: getattr(ft, name) for name in ("_moment_sweep_cuda", "_moment_sweep_bwd_cuda")}
    threshold = segment_module.PALLAS_SWEEP_THRESHOLD
    segment_module.FUSED_SWEEP_PATH, segment_module.PALLAS_SWEEP_THRESHOLD = True, 1
    ft._moment_sweep_cuda, ft._moment_sweep_bwd_cuda = (ft._table_reference_sweep,
                                                        ft._reference_sweep_vjp)
    try:
        return random_sweep(torch, ltt, functional, seed, V_SLICE, device,
                            rows=slice(0, V_SLICE), settings=settings)
    finally:
        segment_module.FUSED_SWEEP_PATH = None
        segment_module.PALLAS_SWEEP_THRESHOLD = threshold
        for name, function in saved.items():
            setattr(ft, name, function)


def path_v_sweep(torch, ltt, ft, hist, fused, functional, segment_module, card):
    """V2: each random lattice at SWEEP_BATCH settings (RANDOM_FIELDS drawn
    per setting), a float64 ParameterBeam through B3 and the gradient of
    ``random_sweep_loss`` through B4, launched as the planner predicts
    (``sweep_launches``).  The moments are held to DOUBLE_RTOL of each
    setting's largest entry: all settings against the dense route on the
    card, the first V_SLICE against the CPU's plain B3.  The gradients (see
    FIELD_RTOL): the slice against the plain B3/B4 on the CPU and on the
    card on each field's own scale at FIELD_RTOL, every setting against the
    dense route on the loss's scale at ROUTE_RTOL; d/dk1 at |k1| < K1_SMALL
    to K1_SMALL_RTOL of the entry."""
    B = SWEEP_BATCH
    launched_total = {"B3": 0, "B4": 0}
    worst = dict(forward=0.0, slice_forward=0.0, gradient=0.0, field=0.0, plain_spread=0.0,
                 small_k1=0.0)
    by_field = {}  # field name -> the readings where it is worst on its own scale
    lattices, worst_dense = {}, (-1.0, None)
    for seed in RANDOM_SEEDS:
        reset_counts(ft, hist)
        with plain_on_cuda_guard(torch, ft) as plain:
            lattice, settings, out, tuned, grads = random_sweep(
                torch, ltt, functional, seed, B, "cuda")
            torch.cuda.synchronize()
        launched = counts(ft)
        lattices[seed] = lattice
        expected = sweep_launches(torch, fused, lattice,
                                  random_parameter_beam(torch, ltt, B, "cuda"))
        if ((launched["B3"], launched["B4"]) != expected or plain["count"]
                or launched["B2"] + launched["B5"] + launched["B6"]):
            raise AssertionError(f"V2 seed {seed}: {launched}, the planner's (B3, B4)"
                                 f" {expected}, plain versions on CUDA tensors {plain['count']}")
        for key in launched_total:
            launched_total[key] += launched[key]

        segment_module.FUSED_SWEEP_PATH = False
        try:
            _, _, dense, _, dense_grads = random_sweep(
                torch, ltt, functional, seed, B, "cuda", settings=settings)
        finally:
            segment_module.FUSED_SWEEP_PATH = None
        forward = max(relative_error(torch, a, b) for a, b in
                      ((out._mu, dense._mu), (out._cov, dense._cov)))
        against_dense, dense_own, small = gradient_errors(
            torch, lattice, grads, dense_grads, tuned, settings)

        # The first V_SLICE settings through the plain B3/B4, on the CPU and
        # on the card; the plain version's own spread between the two, and
        # between it and the dense route on the card.
        _, _, host, host_tuned, host_grads = slice_sweep(
            torch, ltt, ft, functional, segment_module, seed, settings, "cpu")
        *_, card_grads = slice_sweep(torch, ltt, ft, functional, segment_module, seed, settings,
                                     "cuda")
        rows = slice(0, V_SLICE)
        slice_forward = max(relative_error(torch, a[rows].cpu(), b) for a, b in
                            ((out._mu, host._mu), (out._cov, host._cov)))
        on_slice = [g[rows] for g in grads]
        _, cpu_own, slice_small = gradient_errors(torch, lattice, on_slice, host_grads,
                                                  host_tuned, settings)
        _, card_own, _ = gradient_errors(torch, lattice, on_slice, card_grads, host_tuned,
                                         settings)
        _, devices, _ = gradient_errors(torch, lattice, card_grads, host_grads, host_tuned,
                                        settings)
        _, routes, _ = gradient_errors(torch, lattice, [g[rows] for g in dense_grads],
                                       card_grads, host_tuned, settings)
        field = {key: max(cpu_own[key], card_own[key]) for key in cpu_own}
        spread = {key: max(devices[key], routes[key]) for key in cpu_own}
        for key, value in (("forward", forward), ("slice_forward", slice_forward),
                           ("gradient", max(against_dense.values(), default=0.0)),
                           ("field", max(field.values(), default=0.0)),
                           ("plain_spread", max(spread.values(), default=0.0)),
                           ("small_k1", max(small, slice_small))):
            worst[key] = max(worst[key], value)
        for key, value in field.items():
            index, name = key
            at = f"seed {seed}, {type(lattice.elements[index]).__name__} {index}"
            if against_dense[key] >= worst_dense[0]:
                worst_dense = (against_dense[key], f"{at}, d/d{name}")
            if value >= by_field.get(name, {}).get("field", -1.0):
                by_field[name] = {"at": at, "field": value, "against_cpu_plain": cpu_own[key],
                                  "against_card_plain": card_own[key],
                                  "plain_cpu_vs_card": devices[key],
                                  "plain_vs_dense": routes[key],
                                  "against_dense_own_scale": dense_own[key]}
        if (max(forward, slice_forward) > DOUBLE_RTOL
                or max(against_dense.values(), default=0.0) > ROUTE_RTOL
                or max(field.values(), default=0.0) > FIELD_RTOL
                or max(small, slice_small) > K1_SMALL_RTOL):
            raise AssertionError(
                f"V2 seed {seed}: B3 against the dense route {forward}, against the CPU's plain"
                f" B3 {slice_forward}; B4 against the dense route on the loss's scale"
                f" {against_dense}; on each field's own scale against the plain B4 on the CPU"
                f" {cpu_own} and on the card {card_own} (the plain version's own spread"
                f" {spread}); d/dk1 at small k1 {small}, {slice_small}")
    print(json.dumps({
        "path": "V2", "what": f"random lattices at B={B} settings, float64 ParameterBeam: B3"
        f" forward against the dense route on the card and, first {V_SLICE} settings, the"
        " CPU's plain B3; B4's gradient against the dense route on the loss's scale (each"
        " cotangent times its field's range, of the setting's largest) and, the slice, against"
        " the plain B4 on the CPU and on the card on each field's own scale",
        "lattices": kinds_of(lattices), "launches": launched_total, "max_err": worst,
        "gradient_at": worst_dense[1], "bounds": {
            "forward": DOUBLE_RTOL, "slice_forward": DOUBLE_RTOL, "gradient": ROUTE_RTOL,
            "field": FIELD_RTOL, "small_k1": K1_SMALL_RTOL},
        "by_field": by_field, "card": card}))
    return launched_total


def path_v_push(torch, ltt, ft, hist, segment_module, card):
    """V3: each random lattice at V_PUSH_BATCH settings (RANDOM_FIELDS per
    setting) over a (V_PUSH_BATCH, V_PUSH_PARTICLES, 7) float64 beam,
    Segment.track through B2 (the cavities between the runs), held against
    the dense push to DOUBLE_RTOL of each setting's largest entry."""
    B, N = V_PUSH_BATCH, V_PUSH_PARTICLES
    total, worst, lattices = 0, 0.0, {}
    for seed in RANDOM_SEEDS:
        lattice = random_lattice(torch, ltt, seed, random_length(seed))
        apply_settings(lattice, random_settings(torch, lattice, B, seed))
        beam = random_particle_beam(torch, ltt, B, N, seed, "cuda")
        lattices[seed] = lattice
        reset_counts(ft, hist)
        with torch.no_grad(), plain_on_cuda_guard(torch, ft) as plain:
            pushed = lattice.track(beam)
            torch.cuda.synchronize()
        launched = counts(ft)
        runs = len(skippable_runs(lattice.elements))
        if launched["B2"] != runs or plain["count"]:
            raise AssertionError(f"V3 seed {seed}: B2 launches {launched['B2']} over {runs} runs,"
                                 f" plain versions on CUDA tensors {plain['count']}")
        total += launched["B2"]
        segment_module.PARTICLE_SWEEP_PATH = False
        try:
            with torch.no_grad():
                dense = lattice.track(beam)
        finally:
            segment_module.PARTICLE_SWEEP_PATH = None
        error = relative_error(torch, pushed.particles, dense.particles)
        worst = max(worst, error)
        if error > DOUBLE_RTOL or not bool(torch.isfinite(pushed.particles).all()):
            raise AssertionError(f"V3 seed {seed}: B2 and the dense push disagree: {error}")
    print(json.dumps({
        "path": "V3", "what": f"random lattices, ({B}, {N}, 7) float64 ParticleBeams,"
        " Segment.track through B2 against the dense push",
        "lattices": kinds_of(lattices), "launches": {"B2": total},
        "max_err": {"particles": worst}, "bounds": {"particles": DOUBLE_RTOL}, "card": card}))
    return total


def aperture_of(torch, ltt, functional, elements, B, dtype, device="cuda"):
    """An aperture for the end of ``elements`` (the first half of a random
    lattice at B settings): its half-width in each plane the median over
    the settings of |mu| + V_APERTURE_SIGMAS sigma there (the nominal
    ParameterBeam, dense route), so that it cuts into most settings' spots
    and closes on some."""
    with torch.no_grad():
        at, _ = functional.track(ltt.Segment(elements),
                                 random_parameter_beam(torch, ltt, B, device))
    kw = dict(dtype=dtype, device=device)
    half_widths = [float((mu.abs() + V_APERTURE_SIGMAS * sigma).median())
                   for mu, sigma in ((at.mu_x, at.sigma_x), (at.mu_y, at.sigma_y))]
    return ltt.Aperture(x_max=torch.tensor([half_widths[0]], **kw),
                        y_max=torch.tensor([half_widths[1]], **kw), name="aperture_mid", **kw)


def band_errors(torch, ft, kernel_operands, plain_operands, got):
    """B6's float sums ``got`` against its plain version in double on the
    rounded inputs, each setting bounded by what flips can contribute.  A
    particle flips across a rectangular aperture's edge only within the
    band where the kernel's plane value can differ from the plain one's:
    the float plane coefficients' difference from the double ones plus
    float rounding of the plane's k-term sum (gamma_k of its |terms|), times
    each aug row's largest |value|.  The plain version at the edges moved
    out and in by that band gives the band's particles: their count n and
    the diagonal D of their second-moment sums.  By Cauchy-Schwarz flips move
    s2[r, c] by at most sqrt(D_r D_c) and s1[r] by sqrt(n D_r), on top of
    MOMENT_FLOAT_RTOL on ``sum_errors``' scales; and each setting's
    survivors lie between the two.  Returns (worst error in units of its
    bound, the survivors outside the band, readings of the worst setting)."""
    apertures, planes, bounds, aug, w0 = plain_operands
    unit = torch.finfo(torch.float32).eps / 2
    reach = aug.abs().amax(dim=1)  # each aug row's largest |value|
    difference = (kernel_operands[1].double() - planes).abs()
    wide, narrow = bounds.clone(), bounds.clone()
    row = 0
    for a, (shape, x_rows, y_rows) in enumerate(apertures):
        if shape != "rectangular":
            raise ValueError("band_errors: rectangular apertures only")
        for plane, aug_rows in enumerate((x_rows, y_rows)):
            k = len(aug_rows)
            gamma = k * unit / (1 - k * unit)
            rows = slice(row, row + k)
            band = ((difference[rows] + gamma * planes[rows].abs()) * reach[list(aug_rows), None]
                    ).sum(dim=0) + (kernel_operands[2][a, plane].double() - bounds[a, plane]).abs()
            wide[a, plane] = bounds[a, plane] + band
            narrow[a, plane] = (bounds[a, plane] - band).clamp_min(0.0)
            row += k
    want = gram_sums(ft.packed_gram_reference(apertures, planes, bounds, aug, w0))
    outer = gram_sums(ft.packed_gram_reference(apertures, planes, wide, aug, w0))
    inner = gram_sums(ft.packed_gram_reference(apertures, planes, narrow, aug, w0))
    s1, s2, w = (t.detach().double() for t in got)
    e1, e2, ew = want
    n = outer[2] - inner[2]
    D = (outer[1] - inner[1]).diagonal(dim1=1, dim2=2).clamp_min(0.0)
    scale2 = e2.abs().amax(dim=(1, 2)).clamp_min(1e-300)
    scale1 = (ew.clamp_min(1.0) * e2.diagonal(dim1=1, dim2=2).abs().amax(dim=1)).sqrt()
    bound2 = MOMENT_FLOAT_RTOL * scale2[:, None, None] + (D[:, :, None] * D[:, None, :]).sqrt()
    bound1 = MOMENT_FLOAT_RTOL * scale1[:, None] + (n[:, None] * D).sqrt()
    error = torch.maximum(((s2 - e2).abs() / bound2.clamp_min(1e-300)).amax(dim=(1, 2)),
                          ((s1 - e1).abs() / bound1.clamp_min(1e-300)).amax(dim=1))
    outside = int(((w < inner[2]) | (w > outer[2])).sum())
    worst = int(error.argmax())
    return float(error[worst]), outside, {
        "W": float(ew[worst]), "flips": float((w - ew)[worst]), "band": float(n[worst]),
        "most_flips": float((w - ew).abs().max()), "largest_band": float(n.max())}


def path_v_moments(torch, ltt, ft, hist, fused, functional, ParticleBeam, card):
    """V4: each random lattice with its cavities switched off (voltage 0:
    the plan takes affine maps only) and an aperture inserted mid-lattice,
    over one shared MOMENT_PARTICLES cloud: B5 at B = 8 in float64 and B6 at
    B = 256 in float32 (sweep_particle_moments), each against its plain
    version on the card on the same operands (B5 to MOMENT_DOUBLE_RTOL with
    equal weight sums; B6 against the double plain version on the rounded
    inputs within ``band_errors``' bound, its survivors within the
    apertures' rounding band, at most MAX_FLIPS net flips a setting)."""
    totals = {"B5": 0, "B6": 0}
    worst = {"B5": 0.0, "B6": 0.0, "B6 at": None, "B6 flips": 0.0, "B6 outside band": 0}
    lattices, survivors = {}, {}
    for B, kernel, dtype in ((V_MOMENT_BATCHES[0], "B5", torch.float64),
                             (V_MOMENT_BATCHES[1], "B6", torch.float32)):
        cloud = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=111, dtype=dtype)
        particles = cloud.particles[0]
        weights = torch.ones(MOMENT_PARTICLES, dtype=dtype, device="cuda")
        for seed in RANDOM_SEEDS:
            lattice = random_lattice(torch, ltt, seed, random_length(seed), dtype=dtype)
            apply_settings(lattice, random_settings(torch, lattice, B, seed, cavities=False))
            half = len(lattice.elements) // 2
            elements = list(lattice.elements)
            elements.insert(half, aperture_of(torch, ltt, functional, elements[:half], B, dtype))
            lattices[seed] = ltt.Segment(elements)
            reset_counts(ft, hist)
            with torch.no_grad(), plain_on_cuda_guard(torch, ft) as plain:
                entries, scalars = plan_of(torch, fused, elements, B, dtype)
                _, _, w_sum = ft.sweep_particle_moments(entries, scalars, particles, weights)
                torch.cuda.synchronize()
            launched = counts(ft)
            if launched[kernel] != 1 or launched["B5"] + launched["B6"] != 1 or plain["count"]:
                raise AssertionError(f"V4 seed {seed}, B={B}: {launched}, plain versions on"
                                     f" CUDA tensors {plain['count']}")
            totals[kernel] += 1
            survivors[f"{kernel} seed {seed}"] = [int(w_sum.min()), int(w_sum.max())]

            ops = kernel_operands(torch, ft, fused, elements, B, particles)
            with torch.no_grad():
                if kernel == "B5":
                    errors = sum_errors(torch, ft.particle_moment_sweep(*ops),
                                        ft._moment_sweep_reference(*ops))
                    worst["B5"] = max(worst["B5"], *errors[:2])
                    failed = max(errors[:2]) > MOMENT_DOUBLE_RTOL or errors[2] != 0
                else:
                    rounded = (ops[0], tuple(v.double() for v in ops[1]), ops[2].double(),
                               ops[3].double())
                    packed = ft._packed_operands(*ops)[0]
                    got = gram_sums(ft.packed_gram(*packed))
                    error, outside, reading = band_errors(
                        torch, ft, packed, ft._packed_operands(*rounded)[0], got)
                    errors = (error, outside, reading)
                    if error >= worst["B6"]:
                        worst["B6"], worst["B6 at"] = error, {"seed": seed, **reading}
                    worst["B6 flips"] = max(worst["B6 flips"], reading["most_flips"])
                    worst["B6 outside band"] += outside
                    failed = error > 1 or outside or reading["most_flips"] > MAX_FLIPS
            if failed or not 0 < float(w_sum.max()) or float(w_sum.min()) == MOMENT_PARTICLES:
                raise AssertionError(f"V4 seed {seed}, B={B}: {kernel} and its plain version"
                                     f" disagree: {errors}; survivors {survivors}")
    print(json.dumps({
        "path": "V4", "what": "random lattices (cavities off) with an aperture mid-lattice over"
        f" one {MOMENT_PARTICLES}-particle cloud: B5 at B={V_MOMENT_BATCHES[0]} float64, B6 at"
        f" B={V_MOMENT_BATCHES[1]} float32, against their plain versions on the card",
        "lattices": kinds_of(lattices), "launches": totals, "max_err": worst,
        "bounds": {"B5": MOMENT_DOUBLE_RTOL, "B6": f"1: {MOMENT_FLOAT_RTOL} of the sums' scales"
                   " plus what the particles in the apertures' rounding band can contribute",
                   "B6 flips": MAX_FLIPS, "B6 outside band": 0},
        "survivors": survivors, "card": card}))
    return totals


def path_v_read(torch, ltt, ft, hist, functional, card):
    """V5: each random lattice at V_READ_BATCH settings with a 2448 x 2040
    screen appended (its pixels sized so the spots and V_READ_HALF_SIGMAS
    sigma fit, its window derived at V_READ_K_SIGMA sigma) read by one
    MOMENT_PARTICLES cloud, float64, through B1 in count mode; the image
    exactly the scatter's on the same particles."""
    B, N = V_READ_BATCH, MOMENT_PARTICLES
    total, lattices, windows = 0, {}, {}
    for seed in RANDOM_SEEDS:
        lattice = random_lattice(torch, ltt, seed, random_length(seed))
        apply_settings(lattice, random_settings(torch, lattice, B, seed))
        with torch.no_grad():
            at, _ = functional.track(lattice, random_parameter_beam(torch, ltt, B, "cuda"))
        pixel = [float(2 * ((mu.abs().max() + V_READ_HALF_SIGMAS * sigma.max()) / n))
                 for mu, sigma, n in ((at.mu_x, at.sigma_x, 2448), (at.mu_y, at.sigma_y, 2040))]
        screen = ltt.Screen(resolution=(2448, 2040),
                            pixel_size=torch.tensor(pixel, dtype=torch.float64),
                            is_active=True, name="random_screen", dtype=torch.float64,
                            device="cuda")
        screen.histogram_window = screen.derive_histogram_window(at, k_sigma=V_READ_K_SIGMA)
        windows[str(seed)] = list(screen.histogram_window)
        segment = ltt.Segment([*lattice.elements, screen])
        lattices[seed] = segment
        beam = random_particle_beam(torch, ltt, B, N, seed, "cuda")
        reset_counts(ft, hist)
        hist.reset_histogram_fallback_count()
        with torch.no_grad():
            _, diagnostics = functional.track(segment, beam)
            image = diagnostics["random_screen"]
            torch.cuda.synchronize()
        launches, fallbacks = hist.window_histogram.launches, hist.histogram_fallback_count()
        hist.SCREEN_WINDOWED_PATH = False
        try:
            with torch.no_grad():
                _, diagnostics = functional.track(segment, beam)
        finally:
            hist.SCREEN_WINDOWED_PATH = None
        scatter = diagnostics["random_screen"]
        mass = image.sum(dim=(-2, -1))
        if launches != hist.READ_LAUNCHES or fallbacks or not torch.equal(image, scatter):
            raise AssertionError(f"V5 seed {seed}: B1 launches {launches}, fallbacks {fallbacks},"
                                 f" the image {'equals' if torch.equal(image, scatter) else 'differs from'}"
                                 f" the scatter's")
        if tuple(image.shape) != (B, 2040, 2448) or not bool((mass == N).all()):
            raise AssertionError(f"V5 seed {seed}: image {tuple(image.shape)}, mass {mass.tolist()}")
        total += launches
    print(json.dumps({
        "path": "V5", "what": f"random lattices at B={B} settings with a screen appended, one"
        f" {N}-particle float64 cloud read through B1 in count mode against the scatter",
        "lattices": kinds_of(lattices), "launches": {"B1": total}, "windows": windows,
        "max_err": {"image": 0.0}, "bounds": {"image": "exactly equal"}, "card": card}))
    return total


# -- path J: the compiled entry points (CUDA graphs) --------------------------------

JIT_CALLS = 50  # J1: calls a turn (CUDA events), eager and replay alternated
RETUNED_K1 = {"AREAMQZM1": 3.9, "AREAMQZM2": -4.4, "AREAMQZM3": 2.3}  # J1: new k1, same shape
WIDE_SIGMA_X = 3e-3  # J2: a spot wider than the flagship window (m), most of it on the screen
# J3/J4: the graphed tuner against the eager loop from the same start, in
# float32, with the same Adam (capturable=True: its bias corrections formed
# in float32 on the card): the same kernels on the same values, so float
# rounding at most.  Losses are held relative to the first loss,
# parameters relative to the largest distance a parameter travelled.  The
# default Adam's eager loop forms its bias corrections in double on the
# host: its losses are held to the same bound, its parameters not, since
# the L1 loss's gradient is a sign, which such rounding flips for a
# setting whose beam sits on its target.
JIT_LOSS_RTOL = 1e-5
JIT_PARAM_RTOL = 1e-5
UNTIL_MAX_STEPS = 60  # J4
JAX_ADAM_STEPS = 20  # J3b
GRAD_PARITY_RTOL = 1e-10  # J3b: float64 rounding over JAX_ADAM_STEPS steps
UNTIL_STOP_FROM = 3  # J4: tol is chosen so that the loop stops at or after this step
GYM_STEPS = 100  # J7


def capturable_adam(params):
    """The graphed tuner's optimizer, for its eager loop (J3, J4)."""
    import torch

    return torch.optim.Adam(params, lr=5e-2, capturable=True)


def path_jit_read(torch, ares, functional, graphs, hist, ParticleBeam, card):
    """J1: the flagship read through ``functional.track_jit`` at B = 1 and
    8: one capture per B, the image equal to eager ``track``'s (count mode,
    exactly), re-tuning AREAMQZM1-3 to new k1 (tensors of the same shape
    and dtype) replays with no new capture and equals eager at the new k1;
    ms a call eager against replay (CUDA events, in turns), the capture's
    seconds, the graph's kernels and B1's among them (its DOT dump), B1's
    kernels the profiler traced in a replay, and a replay's device time.
    Returns B1's launches issued (the warm-ups' and the captures')."""
    jit = functional.track_jit.graphed
    issued = 0
    for batch, seed in ((1, 0), (8, 8)):
        segment, beam = flagship(torch, ares, ParticleBeam, batch, "cuda", seed)
        captures = jit.captures
        hist.window_histogram.launches = 0
        image = functional.track_jit(segment, beam)[1]["AREABSCR1"]
        torch.cuda.synchronize()
        issued += hist.window_histogram.launches
        if jit.captures != captures + 1 or hist.window_histogram.launches == 0:
            raise AssertionError(f"J1 B={batch}: track_jit did not capture once through B1")
        eager = functional.track(segment, beam)[1]["AREABSCR1"]
        if not torch.equal(image, eager):
            raise AssertionError(f"J1 B={batch}: the replayed image differs from eager track's")
        for name, k1 in RETUNED_K1.items():
            getattr(segment, name).k1 = torch.full((batch,), k1, device="cuda")
        retuned = functional.track_jit(segment, beam)[1]["AREABSCR1"]
        eager = functional.track(segment, beam)[1]["AREABSCR1"]
        if jit.captures != captures + 1:
            raise AssertionError(f"J1 B={batch}: re-tuning k1 captured again")
        if not torch.equal(retuned, eager) or torch.equal(retuned, image):
            raise AssertionError(f"J1 B={batch}: the re-tuned replay differs from eager track's")
        graph = jit.graphs[-1]
        kernels, b1_kernels = graphs.graph_kernel_count(graph), graphs.graph_kernel_count(
            graph, "windowed_read_")
        times = {"eager": [], "replay": []}
        for mode in ("eager", "replay", "replay", "eager"):
            track = functional.track if mode == "eager" else functional.track_jit
            times[mode].append(cuda_ms(lambda: track(segment, beam), iters=JIT_CALLS))
        replay_ms = cuda_ms(graph.replay, iters=JIT_CALLS)
        traced = device_launches(lambda: functional.track_jit(segment, beam))
        traced_b1 = sum(count for name, count in traced.items() if "windowed_read_" in name)
        device = device_ms(lambda: functional.track_jit(segment, beam), iters=10)
        print(f"J1 B={batch}: track_jit image equal to eager track's, and after re-tuning"
              f" {list(RETUNED_K1)} (no new capture; {jit.captures} captures in all); a call:"
              f" eager {times['eager'][0]:.4f} / {times['eager'][1]:.4f} ms, replay"
              f" {times['replay'][0]:.4f} / {times['replay'][1]:.4f} ms (CUDA events,"
              f" {JIT_CALLS} calls a turn, in turns: eager, replay, replay, eager); the graph"
              f" alone {replay_ms:.4f} ms a replay; capture {jit.capture_seconds[-1]:.3f} s"
              f" (warm-up included, host clock); the graph's kernels {kernels}, B1's {b1_kernels}"
              f" (DOT dump); a replay's device time {device:.5f} ms and B1 kernels traced"
              f" {traced_b1} (torch.profiler, with the inputs' copies and the outputs' clones;"
              f" {sum(traced.values())} device events a call); card {card}")
        if b1_kernels != hist.READ_LAUNCHES:
            raise AssertionError(f"J1 B={batch}: the graph holds {b1_kernels} B1 kernels")
    return issued


def path_jit_fallback(torch, ares, functional, hist, ParticleBeam, card):
    """J2: B1's fallback decided on the card.  A spot wider than the
    window, eager and through ``track_jit``, whose capturing call (warm-ups
    and capture) is on the wide spot: the image equals
    ``weighted_histogram_2d``'s scatter on the card and the device counter
    advances by one a read, the capturing call's too; a fitting spot does
    not advance it and replays the same graph; B1's
    completion against its plain version on the card (count and weighted
    mode, wide and fitting spots); the eager read's call time beside the
    scatter's.  Returns (B1's launches, max |error|)."""
    segment, beam = flagship(torch, ares, ParticleBeam, 1, "cuda", seed=0)
    _, wide = flagship(torch, ares, ParticleBeam, 1, "cuda", seed=3, sigma_x=WIDE_SIGMA_X)
    args = screen_read_args(segment, wide)
    scatter = hist.weighted_histogram_2d(args["x"], args["y"], args["weights"], args["x_range"],
                                         args["y_range"], args["bins"])
    captures = functional.track_jit.graphed.captures
    hist.reset_histogram_fallback_count()
    hist.window_histogram.launches = 0
    image = functional.track_jit(segment, wide)[1]["AREABSCR1"]  # this segment's capture
    fallbacks = hist.histogram_fallback_count()
    if functional.track_jit.graphed.captures != captures + 1 or fallbacks != 1:
        raise AssertionError(f"J2: the capturing call on the wide spot counted {fallbacks} reads")
    if not torch.equal(image, scatter):
        raise AssertionError("J2: the capturing call's image is not the scatter's")
    captures += 1
    for label, track in (("eager", functional.track), ("track_jit", functional.track_jit)):
        before = hist.histogram_fallback_count()
        image = track(segment, wide)[1]["AREABSCR1"]
        if hist.histogram_fallback_count() != before + 1 or not torch.equal(image, scatter):
            raise AssertionError(f"J2 {label}: the wide spot's read is not the counted scatter")
        before = hist.histogram_fallback_count()
        track(segment, beam)
        if hist.histogram_fallback_count() != before:
            raise AssertionError(f"J2 {label}: a fitting spot advanced the fallback counter")
    launches = hist.window_histogram.launches
    if functional.track_jit.graphed.captures != captures:
        raise AssertionError("J2: a later call captured again")
    worst = 0.0
    read = screen_read_args(segment, beam)
    for label, a in (("wide", args), ("fitting", read)):
        x, y, w, bins = a["x"], a["y"], a["weights"], a["bins"]
        ranges, window = (*a["x_range"], *a["y_range"]), hist._window_shape(a["window"], *bins)
        for binary in (True, False):
            image = hist.windowed_read(x, y, w, ranges, bins, window, binary)[0]
            plain = plain_read(hist, x, y, w, ranges, bins, window, binary)[0]
            torch.cuda.synchronize()
            if binary and not torch.equal(image, plain):
                raise AssertionError(f"J2 {label}: the completion differs from its plain version")
            if not torch.allclose(image, plain, rtol=READ_RTOL, atol=0.0):
                raise AssertionError(f"J2 {label}: the weighted completion past {READ_RTOL}")
            worst = max(worst, float((image - plain).abs().max()))
    x, y, w, bins = args["x"], args["y"], args["weights"], args["bins"]
    ranges, window = (*args["x_range"], *args["y_range"]), hist._window_shape(args["window"], *bins)
    read_ms = cuda_ms(lambda: hist.windowed_read(x, y, w, ranges, bins, window, True), iters=50)
    scatter_ms = cuda_ms(lambda: hist.weighted_histogram_2d(x, y, w, args["x_range"],
                                                            args["y_range"], bins), iters=50)
    hist.reset_histogram_fallback_count()
    print(f"J2: a spot of sigma_x {WIDE_SIGMA_X} m past the window {window}: eager and"
          f" track_jit images equal the scatter's, the device counter one a read (the capturing"
          f" call's, on the wide spot, too), none for a fitting spot; the completion against its"
          f" plain version (count exact, weighted max"
          f" |err| {worst:.3e}); the wide read {read_ms:.4f} ms a call (three B1 launches), the"
          f" scatter {scatter_ms:.4f} ms (CUDA events, 50 calls; card {card})")
    return launches, worst


def path_tuning_problem(torch, envs, env, seed=31):
    """Path T's problem: (SWEEP_BATCH, 5) settings, its loss and start."""
    params = sweep_params(torch, envs, SWEEP_BATCH, "cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    start = torch.rand((SWEEP_BATCH, 5), generator=gen, device="cuda") - 0.5

    def loss_fn(magnets, params):
        observed = env.batched_beam_parameters(magnets, params)
        return torch.mean(torch.abs(observed - params.target))

    return params, start, loss_fn


def tuner_errors(torch, start, got, want, got_losses, want_losses):
    """(loss error, parameter error) of a graphed run against the eager one."""
    loss = float((got_losses.double() - want_losses.double()).abs().max()
                 / want_losses[0].abs().double())
    travelled = (want.detach() - start).abs().max().double()
    param = float((got.detach() - want.detach()).abs().max().double() / travelled)
    return loss, param


def path_jit_tuner(torch, ft, hist, envs, env, tuning, card):
    """J3: path T's tuner graphed (``tuning.tune``: one step captured, B3
    and B4 in it) against the eager loop (``graph=False``) from the same
    start, losses and parameters within JIT_LOSS_RTOL / JIT_PARAM_RTOL;
    ms a step of each (a tuner's 10 steps, CUDA events) and the B3/B4
    kernels the profiler traced in a replayed step.  Returns the launches
    issued (the warm-up's and the capture's)."""
    params, start, loss_fn = path_tuning_problem(torch, envs, env)
    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        tuned, losses = tuning.tune(loss_fn, start, params, steps=SWEEP_STEPS)
        torch.cuda.synchronize()
    launched = counts(ft)
    eager, eager_losses = tuning.tune(loss_fn, start, params, steps=SWEEP_STEPS, graph=False,
                                      optimizer=capturable_adam)
    loss_error, param_error = tuner_errors(torch, start, tuned, eager, losses, eager_losses)
    _, host_losses = tuning.tune(loss_fn, start, params, steps=SWEEP_STEPS, graph=False)
    host_error = tuner_errors(torch, start, tuned, tuned, losses, host_losses)[0]
    if launched["B3"] < 1 or launched["B4"] < 1 or plain["count"]:
        raise AssertionError("J3: the captured step did not go through B3 and B4")
    if max(loss_error, host_error) > JIT_LOSS_RTOL or param_error > JIT_PARAM_RTOL:
        raise AssertionError(f"J3: graphed tuner off the eager loop ({loss_error:.2e},"
                             f" {param_error:.2e}, {host_error:.2e})")
    ms = {}
    for graph in (True, False, False, True):
        magnets = start.clone().requires_grad_(True)
        tuner = tuning.make_tuner(torch.optim.Adam([magnets], lr=5e-2), loss_fn, graph=graph)
        ms.setdefault(graph, []).append(
            cuda_ms(lambda: tuner(magnets, SWEEP_STEPS, params), iters=3, warmup=1) / SWEEP_STEPS)
    traced = device_launches(lambda: tuner(magnets, 1, params))
    traced = {k: sum(c for n, c in traced.items() if k in n)
              for k in ("moment_sweep_kernel", "moment_sweep_bwd_kernel")}
    print(f"J3: tune of ({SWEEP_BATCH}, 5) settings, {SWEEP_STEPS} Adam steps, graphed against"
          f" the eager loop with the same Adam (capturable=True): loss {float(losses[0]):.6e} ->"
          f" {float(losses[-1]):.6e}, losses within {loss_error:.3e} of the first, parameters"
          f" within {param_error:.3e} of the largest distance travelled (bounds {JIT_LOSS_RTOL},"
          f" {JIT_PARAM_RTOL}); against the default Adam's eager loop, losses within"
          f" {host_error:.3e};"
          f" launches issued {launched}; a step: graphed {ms[True][0]:.4f} / {ms[True][1]:.4f} ms,"
          f" eager {ms[False][0]:.4f} / {ms[False][1]:.4f} ms (CUDA events, 3 runs of"
          f" {SWEEP_STEPS} steps a turn, in turns); B3/B4 kernels traced in a replayed step"
          f" {traced} (torch.profiler); card {card}")
    return launched


def path_jit_float64_adam(torch, ltt, functional, tuning, card):
    """J3b: the captured Adam in float64.  A capturable Adam forms its bias
    corrections from its step tensor; the tuner makes it in the parameters'
    precision, so a float64 tune step graphed agrees with the default
    Adam's eager loop (corrections in double on the host) to rounding:
    losses and parameters within GRAD_PARITY_RTOL of the first loss and of
    the distance travelled (a float32 step count would put them ~1e-6
    apart).  Two quadrupoles and two drifts tune a ParameterBeam's sigma_x
    and sigma_y to targets, JAX_ADAM_STEPS steps."""
    kw = dict(dtype=torch.float64, device="cuda")
    mu = torch.zeros((1, 7), **kw)
    mu[0, 6] = 1.0
    cov = torch.diag(torch.tensor([1e-8, 4e-10, 1.2e-8, 3e-10, 1e-10, 1e-6, 0.0], **kw))[None]
    beam = ltt.ParameterBeam(mu, cov, torch.full((1,), 1e8, **kw))
    lengths = {k: torch.full((1,), v, **kw) for k, v in (("q", 0.2), ("d1", 0.4), ("d2", 1.5))}

    def loss_fn(p, beam):
        segment = ltt.Segment([
            ltt.Quadrupole(lengths["q"], k1=p[:1] * 10, **kw), ltt.Drift(lengths["d1"], **kw),
            ltt.Quadrupole(lengths["q"], k1=p[1:] * 10, **kw), ltt.Drift(lengths["d2"], **kw)],
            name="j3b")
        out, _ = functional.track(segment, beam)
        return ((out.sigma_x[0] - 3e-4) * 1e4) ** 2 + ((out.sigma_y[0] - 1.5e-4) * 1e4) ** 2

    start = torch.tensor([0.3, -0.25], **kw)
    graphed, graphed_losses = tuning.tune(loss_fn, start, beam, steps=JAX_ADAM_STEPS)
    eager, eager_losses = tuning.tune(loss_fn, start, beam, steps=JAX_ADAM_STEPS, graph=False)
    loss_error, param_error = tuner_errors(torch, start, graphed, eager, graphed_losses,
                                           eager_losses)
    print(f"J3b: a float64 tune ({JAX_ADAM_STEPS} Adam steps) graphed (capturable Adam, its step"
          f" count in float64) against the default Adam's eager loop: losses within"
          f" {loss_error:.3e} of the first, parameters within {param_error:.3e} of the distance"
          f" travelled (bound {GRAD_PARITY_RTOL}); loss {float(eager_losses[0]):.6e} ->"
          f" {float(eager_losses[-1]):.6e}; card {card}")
    if max(loss_error, param_error) > GRAD_PARITY_RTOL:
        raise AssertionError("J3b: the captured float64 Adam differs from the eager one")


def until_tol(torch, losses):
    """``(tol, step)``: a tol at which JAX's test stops the loop at a step
    between UNTIL_STOP_FROM and the history's end: the geometric mean of
    the first improvement from UNTIL_STOP_FROM on below 0.9 of the least
    before it and that least, far from both."""
    history = losses.float().double()  # as the float32 history holds them
    steps = history.numel()
    deltas = {i: abs(float(history[i - 2]) - float(losses[i - 1])) for i in range(2, steps + 1)}
    for i in range(UNTIL_STOP_FROM, steps):
        least = min(deltas[j] for j in range(2, i))
        if deltas[i] < 0.9 * least:  # a clear new minimum: rounding moves neither past tol
            return math.sqrt(deltas[i] * least), i
    raise AssertionError(f"J4: the eager losses give no stopping tol: improvements"
                         f" {[f'{d:.3e}' for d in deltas.values()]}")


def path_jit_until(torch, ft, hist, envs, env, tuning, card):
    """J4: ``tune_until`` graphed on path T's problem with a tol at which
    it stops between step 2 and UNTIL_MAX_STEPS: the same number of steps
    as the eager loop, parameters within J3's bounds; the host reads of the
    stop flag."""
    params, start, loss_fn = path_tuning_problem(torch, envs, env)
    _, eager_losses = tuning.tune(loss_fn, start, params, steps=UNTIL_MAX_STEPS, graph=False,
                                  optimizer=capturable_adam)
    tol, expected = until_tol(torch, eager_losses)
    reset_counts(ft, hist)
    tuned, history, steps = tuning.tune_until(loss_fn, start, params, tol=tol,
                                              max_steps=UNTIL_MAX_STEPS)
    reads = tuning.tune_until.host_reads
    launched = counts(ft)
    eager, eager_history, eager_steps = tuning.tune_until(
        loss_fn, start, params, tol=tol, max_steps=UNTIL_MAX_STEPS, graph=False,
        optimizer=capturable_adam)
    if not (2 < steps < UNTIL_MAX_STEPS and steps == eager_steps):
        raise AssertionError(f"J4: tune_until took {steps} steps graphed, {eager_steps} eager"
                             f" (tol {tol:.4e}, the eager losses' test stops at {expected})")
    loss_error, param_error = tuner_errors(torch, start, tuned, eager, history[:steps],
                                           eager_history[:eager_steps])
    print(f"J4: tune_until with tol {tol:.4e} (max_steps {UNTIL_MAX_STEPS}): {steps} steps"
          f" graphed, {eager_steps} eager (the eager losses' test stops at {expected});"
          f" {reads} host reads of the stop flag (one every {tuning.UNTIL_READ_EVERY} replays);"
          f" losses within {loss_error:.3e}, parameters within {param_error:.3e} (bounds"
          f" {JIT_LOSS_RTOL}, {JIT_PARAM_RTOL}); launches issued {launched}; card {card}")
    if loss_error > JIT_LOSS_RTOL or param_error > JIT_PARAM_RTOL:
        raise AssertionError("J4: graphed tune_until off the eager loop")
    if not bool(torch.isnan(history[steps:]).all()):
        raise AssertionError("J4: the history past the last step is not NaN")
    return launched


def path_jit_cavities(torch, ltt, ft, hist, functional, graphs, card):
    """J5: the random lattice of path V's generator with the most cavities,
    B = SWEEP_BATCH float64 settings of every field, captured with every
    cavity at zero voltage (``graphs.graphed(functional.track)``: the
    cavities take the active path under capture) and replayed at non-zero
    voltages: against eager ``track`` at the same settings (the same
    route, DOUBLE_RTOL per setting), and the zero-voltage replay against
    eager track's folded route (ROUTE_RTOL)."""
    cavities = {seed: sum(isinstance(e, ltt.Cavity) for e in random_lattice(
        torch, ltt, seed, random_length(seed), device="cpu").elements) for seed in RANDOM_SEEDS}
    seed = max(RANDOM_SEEDS, key=lambda s: (cavities[s], -s))
    lattice = random_lattice(torch, ltt, seed, random_length(seed))
    B = SWEEP_BATCH
    beam = random_parameter_beam(torch, ltt, B, "cuda")
    jitted = graphs.graphed(functional.track)
    reset_counts(ft, hist)
    errors = {}
    for label, cavities_on, bound in (("zero voltage", False, ROUTE_RTOL),
                                      ("non-zero voltages", True, DOUBLE_RTOL)):
        apply_settings(lattice, random_settings(torch, lattice, B, seed + int(cavities_on),
                                                cavities=cavities_on))
        got = jitted(lattice, beam)[0]
        want = functional.track(lattice, beam)[0]
        errors[label] = max(relative_error(torch, got._mu, want._mu),
                            relative_error(torch, got._cov, want._cov),
                            relative_error(torch, got.energy, want.energy, per_setting=False))
        if errors[label] > bound:
            raise AssertionError(f"J5 {label}: replay against eager track {errors[label]:.2e}")
    launched = counts(ft)
    print(f"J5: seed {seed}'s lattice ({random_length(seed)} elements, {cavities[seed]}"
          f" cavities), {B} float64 settings: captured at zero voltage, replayed at non-zero"
          f" voltages ({jitted.captures} capture): against eager track"
          f" {errors['non-zero voltages']:.3e}"
          f" per setting (bound {DOUBLE_RTOL}), the zero-voltage replay against the folded route"
          f" {errors['zero voltage']:.3e} (bound {ROUTE_RTOL}); launches issued {launched};"
          f" card {card}")
    if jitted.captures != 1 or launched["B3"] < 1:
        raise AssertionError("J5: the lattice captured more than once or skipped B3")
    return launched


def path_jit_grad(torch, ft, hist, envs, env, functional, card):
    """J6: d(loss)/d(settings) of the env's subcell at SWEEP_BATCH settings
    through ``track_jit`` (forward and backward captured together: B3 and
    B4 in the graphs) against eager ``track``, within path T's GRAD_RTOL of
    each column's largest |value|."""
    params, start, _ = path_tuning_problem(torch, envs, env, seed=61)

    def gradient(track):
        magnets = start.clone().requires_grad_(True)
        segment = env._batched_tuned_segment(magnets)
        beam = env._incoming(params.incoming_mu, params.incoming_sigma)
        out = track(segment, beam)[0]
        observed = torch.stack([out.mu_x, out.sigma_x, out.mu_y, out.sigma_y], dim=-1)
        return torch.autograd.grad(torch.mean(torch.abs(observed - params.target)), magnets)[0]

    captures = functional.track_jit.graphed.captures
    reset_counts(ft, hist)
    got = gradient(functional.track_jit)
    again = gradient(functional.track_jit)  # a replay of both graphs
    torch.cuda.synchronize()
    launched = counts(ft)
    want = gradient(functional.track)
    error = max(float(((g.double() - want.double()).abs() / want.double().abs().amax(dim=0)).max())
                for g in (got, again))
    print(f"J6: d(loss)/d(settings) through track_jit at {SWEEP_BATCH} settings against eager"
          f" track: max error {error:.3e} of each column's largest |value| (bound {GRAD_RTOL});"
          f" captures {functional.track_jit.graphed.captures - captures}; launches issued"
          f" {launched}; card {card}")
    if error > GRAD_RTOL or launched["B4"] < 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError("J6: the graphed gradient differs from eager track's")
    if functional.track_jit.graphed.captures != captures + 1:
        raise AssertionError("J6: the second gradient captured again")
    return launched


def gym_stand_in():
    """The two names of gymnasium that the Gym adapter uses (``Env`` with
    ``reset(seed=...)``, ``spaces.Box``): the card's machine has no
    gymnasium, and the adapter takes its module as an argument."""
    import types

    class Env:
        def reset(self, *, seed=None, options=None):
            return None

    return types.SimpleNamespace(Env=Env, spaces=types.SimpleNamespace(Box=lambda **kw: kw))


def path_jit_gym(torch, envs, card):
    """J7: the Gym adapter's graphed step and reset (its generator
    registered with the reset's graph): GYM_STEPS steps from
    ``reset(seed=3)`` and then two resets without a seed (the generator
    drawn on), against the same on an adapter whose step and reset are the
    eager ``env.step`` and ``env.reset``, equal observations, rewards and
    dones; ms a step of each (host clock: a step reads its reward)."""
    import numpy as np

    from lynx_tpu_torch.envs import ares_ea

    adapter = ares_ea._gym_env_class(gym_stand_in())
    graphed, eager = adapter(device="cuda"), adapter(device="cuda")
    eager._step, eager._reset = eager._env.step, eager._env.reset
    actions = np.random.default_rng(7).uniform(-1, 1, (GYM_STEPS, 5)).astype(np.float32)
    seconds, results = {}, {}
    for label, gym in (("graphed", graphed), ("eager", eager), ("graphed again", graphed)):
        trail = [gym.reset(seed=3)[0]]
        torch.cuda.synchronize()
        begin = time.perf_counter()
        for action in actions:
            obs, reward, done, _, _ = gym.step(action)
            trail.append((obs, reward, done))
        seconds[label] = (time.perf_counter() - begin) / GYM_STEPS
        trail += [gym.reset()[0], gym.reset()[0]]
        results[label] = trail

    def same(a, b):
        if isinstance(a, tuple):
            return np.array_equal(a[0], b[0]) and a[1:] == b[1:]
        return np.array_equal(a, b)

    equal = all(same(a, b) for a, b in zip(results["graphed"], results["eager"]))
    again = all(same(a, b) for a, b in zip(results["graphed again"], results["eager"]))
    print(f"J7: the Gym adapter, {GYM_STEPS} steps from reset(seed=3) and two resets after:"
          f" graphed and eager observations, rewards and dones equal: {equal} (the graphed run"
          f" again: {again}); captures: step {graphed._step.captures}, reset"
          f" {getattr(graphed._reset, 'captures', 'eager')}; a step: graphed"
          f" {seconds['graphed'] * 1e3:.4f} ms (again {seconds['graphed again'] * 1e3:.4f} ms),"
          f" eager {seconds['eager'] * 1e3:.4f} ms (host clock; card {card})")
    if not (equal and again) or graphed._step.captures != 1:
        raise AssertionError("J7: the graphed Gym steps or resets differ from the eager ones")
    if getattr(graphed._reset, "captures", 1) != 1:
        raise AssertionError("J7: the Gym reset captured more than once")

# -- path J, continued: the JAX package's last jitted sites (J8-J13) ----------------

J_UPDATE_CALLS = 3  # J8: updates a turn (CUDA events), eager and replay alternated
J_STEP_CALLS = 10  # J9, J11: calls a turn
J_APERTURE_PARTICLES = 100_000  # J12
J_APERTURE_BATCH = 8  # J12


def relative_gap(torch, got, want, start=None):
    """max |got - want| over the largest |want| (over the largest distance
    from ``start``, where given), across a list of tensor pairs."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().double(), b.detach().double()
        scale = (b - start[i].detach().double()).abs().max() if start is not None else b.abs().max()
        worst = max(worst, float((a - b).abs().max() / scale.clamp_min(1e-300)))
    return worst


def ppo_run(torch, envs, ppo, policy, params, obs, magnets, noise, gen_seed, graph,
            capturable=True):
    """PPO_UPDATES updates from ``(obs, magnets)``: the first on ``noise``,
    the others drawing from a CUDA generator seeded ``gen_seed``.  Returns
    (update, [(loss, reward, parameters, gradients) after each update],
    policy, optimizer, generator, obs, states)."""
    env = envs.make_env(device="cuda")
    policy = copy.deepcopy(policy)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE,
                                 capturable=capturable)
    update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT, graph=graph)
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    states = envs.EnvState(magnets.clone(), torch.zeros(magnets.shape[0], dtype=torch.int32,
                                                        device="cuda"), gen)
    obs = obs.clone()
    history = []
    for i in range(PPO_UPDATES):
        obs, states, loss, reward = update(policy, obs, states, gen,
                                           noise=noise if i == 0 else None)
        history.append((loss.clone(), reward.clone(),
                        [p.detach().clone() for p in policy.parameters()],
                        [p.grad.clone() for p in policy.parameters()]))
    torch.cuda.synchronize()
    return update, history, policy, optimizer, gen, obs, states


def path_jit_ppo(torch, ft, hist, graphs, envs, ppo, r1, card):
    """J8: PPO's collect_and_update as one CUDA graph (``graph=True``: the
    rollout's env steps, the GAE, the update's forward and backward and a
    capturable Adam step), at R1's shape (SWEEP_BATCH envs, B3 every env
    step) and at the example's PPO_DEFAULT_ENVS (the dense route), from R1's
    start: the first update on R1's noise (a capture of its own), the others
    drawing from a registered generator.  Held to the same step run eagerly
    with the same capturable Adam (losses, rewards, parameters after each
    update; predicted equal, the ceiling R1's bounds), and the first update
    to R1's (default Adam, eager) within R1's SPREAD_FACTOR bounds.  The
    graphs' B3 kernel nodes (DOT dump); ms an update and env-transitions/s
    replayed against eager (CUDA events, in turns), a replay's device busy
    share, capture seconds and whether the AccumulateGrad stream warning
    appears.  Returns the B3 launches issued."""
    import warnings

    spreads, issued = r1["spreads"], 0
    for B in (SWEEP_BATCH, PPO_DEFAULT_ENVS):
        if B == SWEEP_BATCH:
            policy, params, obs, magnets, noise = (r1[k] for k in ("policy", "params", "obs",
                                                                   "magnets", "noise"))
        else:
            gen = torch.Generator(device="cuda").manual_seed(42)
            params = envs.default_params(gen, device="cuda", batch_shape=(B,))
            policy = ppo.MLPPolicy(13, 5, generator=gen, device="cuda")
            env = envs.make_env(device="cuda")
            obs, states = env.batched_reset(gen, params)
            magnets = states.magnets
            noise = torch.randn((PPO_ROLLOUT, B, 5), generator=gen, device="cuda")
        reset_counts(ft, hist)
        with warnings.catch_warnings(record=True) as caught, \
                plain_on_cuda_guard(torch, ft) as plain:
            warnings.simplefilter("always")
            graphed = ppo_run(torch, envs, ppo, policy, params, obs, magnets, noise, 7, True)
        launched = counts(ft)
        issued += launched["B3"]
        stream_warning = any("AccumulateGrad" in str(w.message) for w in caught)
        eager = ppo_run(torch, envs, ppo, policy, params, obs, magnets, noise, 7, False)
        update, history = graphed[0], graphed[1]
        steps = update.cache.steps
        if len(steps) != 2 or plain["count"]:
            raise AssertionError(f"J8 B={B}: {len(steps)} captures, plain versions {plain}")
        nodes = [graphs.graph_kernel_count(step.graph, "moment_sweep_kernel") for step in steps]
        start = [p.detach() for p in policy.parameters()]
        errors = {"loss": 0.0, "reward": 0.0, "parameters": 0.0}
        for (loss, reward, ps, _), (e_loss, e_reward, e_ps, _) in zip(history, eager[1]):
            errors["loss"] = max(errors["loss"], relative_gap(torch, [loss], [e_loss]))
            errors["reward"] = max(errors["reward"], relative_gap(torch, [reward], [e_reward]))
            errors["parameters"] = max(errors["parameters"],
                                       relative_gap(torch, ps, e_ps, start))
        bounds = {"loss": SPREAD_FACTOR * spreads["loss"],
                  "reward": SPREAD_FACTOR * spreads["mean reward"],
                  "parameters": SPREAD_FACTOR * spreads["gradient"]}
        first = {}
        if B == SWEEP_BATCH:  # the first update against R1's (default Adam, eager)
            loss, reward, _, grads = history[0]
            want = r1["first"]
            first = {"loss": relative_gap(torch, [loss], [want[0]]),
                     "mean reward": relative_gap(torch, [reward], [want[1]]),
                     "gradient": max(relative_gap(torch, [g], [w]) for g, w in zip(grads, want[2]))}
        e_update, e_policy, e_gen = eager[0], eager[2], eager[4]
        g_update, g_policy, g_gen = graphed[0], graphed[2], graphed[4]
        carry = {"eager": (eager[5], eager[6]), "replay": (graphed[5], graphed[6])}
        ms = {"eager": [], "replay": []}
        for mode in ("eager", "replay", "replay", "eager"):
            run, pol, gen = ((e_update, e_policy, e_gen) if mode == "eager"
                             else (g_update, g_policy, g_gen))

            def one_update():
                carry[mode] = run(pol, *carry[mode], gen)[:2]
                return carry[mode][0]

            ms[mode].append(cuda_ms(one_update, iters=J_UPDATE_CALLS, warmup=1))
        replay = steps[-1]
        device = device_ms(replay.graph.replay, iters=2)
        replay_ms = cuda_ms(replay.graph.replay, iters=J_UPDATE_CALLS, warmup=1)
        transitions = B * PPO_ROLLOUT * 1000.0
        capture_s = [round(step.capture_seconds, 3) for step in steps]
        print(f"J8 B={B}: collect_and_update captured ({len(steps)} graphs: R1's noise, then the"
              f" registered generator; capture {capture_s} s, warm-up included), B3 kernel nodes"
              f" {nodes} (DOT dump; expected {PPO_ROLLOUT if B >= 16384 else 0} each); against"
              f" the eager step with the same capturable Adam over {PPO_UPDATES} updates: loss"
              f" {errors['loss']:.3e}, mean reward {errors['reward']:.3e}, parameters"
              f" {errors['parameters']:.3e} of the distance travelled (bounds {bounds['loss']:.2e},"
              f" {bounds['reward']:.2e}, {bounds['parameters']:.2e}: R1's); "
              + (f"the first update against R1's (default Adam, eager): "
                 + ", ".join(f"{k} {v:.3e} (bound {SPREAD_FACTOR * spreads[k]:.2e})"
                             for k, v in first.items()) + "; " if first else "")
              + f"an update: replay {ms['replay'][0]:.4f} / {ms['replay'][1]:.4f} ms"
              f" ({transitions / ms['replay'][0]:.1f} env-transitions/s), eager"
              f" {ms['eager'][0]:.4f} / {ms['eager'][1]:.4f} ms"
              f" ({transitions / ms['eager'][0]:.1f}) (CUDA events, {J_UPDATE_CALLS} updates a"
              f" turn, in turns); the graph alone {replay_ms:.4f} ms a replay, device time"
              f" {device:.4f} ms (busy share {device / replay_ms:.4f}; torch.profiler, 2"
              f" replays); launches issued {launched}; AccumulateGrad stream warning:"
              f" {stream_warning}; card {card}")
        expected = PPO_ROLLOUT if B >= 16384 else 0
        if nodes != [expected, expected]:
            raise AssertionError(f"J8 B={B}: B3 kernel nodes {nodes}, expected {expected} each")
        if any(errors[k] > bounds[k] for k in errors):
            raise AssertionError(f"J8 B={B}: the replay differs from the eager step: {errors}")
        if any(first[k] > SPREAD_FACTOR * spreads[k] for k in first):
            raise AssertionError(f"J8: the first update differs from R1's: {first}")
        if not all(math.isfinite(float(h[0])) for h in history):
            raise AssertionError(f"J8 B={B}: non-finite losses")
    return issued


def metric_lines(logging):
    """A handler on the metrics logger collecting its messages, and the
    logger's level to put back."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("lynx_tpu_torch.metrics")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)

    def close():
        logger.removeHandler(handler)
        logger.setLevel(level)

    return lines, close


def line_values(line):
    return dict(part.split("=") for part in line.split())


#: J9: a process that replays a graphed env step three times, logging its
#: metric lines to standard output, and exits without a flush.
EXIT_LINES_SCRIPT = """
import logging, sys
import torch
logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="%(message)s")
from lynx_tpu_torch import graphs
from lynx_tpu_torch.envs import make_env
from lynx_tpu_torch.envs.ares_ea import default_params
env = make_env(log_metrics=True, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
params = default_params(gen, device="cuda", batch_shape=(64,))
_, states = env.batched_reset(gen, params)
step = graphs.graphed(env.batched_step)
actions = torch.zeros((64, env.num_actions), device="cuda")
for _ in range(3):
    step(states, actions, params)
"""


def path_jit_metrics(torch, graphs, envs, ppo, metrics, r1, card):
    """J9: metrics emitted inside a graph (JAX's ``jax.debug.callback``).
    A graphed ``batched_step`` of ``make_env(log_metrics=True)`` at
    SWEEP_BATCH logs one line a replay (after ``metrics.flush()``), equal to
    the eager step's line (step=, the five keys; values within METRIC_RTOL
    of each other); then a graphed PPO update with that env logs
    PPO_ROLLOUT lines an update (the second update's read after
    ``graphs.release()``, which flushes).  Meanwhile a process of its own
    replays a graphed step three times and exits without a flush: its three
    lines must appear (``metrics.flush`` at exit).  ms a step graphed and
    eager."""
    import logging

    at_exit = subprocess.Popen([sys.executable, "-c", EXIT_LINES_SCRIPT], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True,
                               cwd=str(Path(__file__).resolve().parent))

    env = envs.make_env(log_metrics=True, device="cuda")
    params = r1["params"]
    magnets = r1["magnets"]
    start = envs.EnvState(magnets, torch.zeros(magnets.shape[0], dtype=torch.int32,
                                               device="cuda"), None)
    actions = torch.tanh(magnets * 2.0)
    step = graphs.graphed(env.batched_step)
    lines, close = metric_lines(logging)
    try:
        env.batched_step(start, actions, params)
        eager_lines = list(lines)
        del lines[:]
        for _ in range(3):
            step(start, actions, params)
        metrics.flush()
        replay_lines = list(lines)
        del lines[:]
        ms = {"eager": cuda_ms(lambda: env.batched_step(start, actions, params),
                               iters=J_STEP_CALLS),
              "graphed": cuda_ms(lambda: step(start, actions, params), iters=J_STEP_CALLS)}
        metrics.flush()
        del lines[:]
        policy = copy.deepcopy(r1["policy"])
        optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
        update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT)
        gen = torch.Generator(device="cuda").manual_seed(9)
        obs, states = r1["obs"].clone(), envs.EnvState(magnets.clone(), start.step_count, gen)
        per_update = []
        for flush in (metrics.flush, graphs.release):
            obs, states, _, _ = update(policy, obs, states, gen)
            flush()
            per_update.append(len(lines))
            del lines[:]
    finally:
        close()
        try:
            out, err = at_exit.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            at_exit.kill()
            out, err = at_exit.communicate()
    exit_lines = [line for line in out.splitlines() if "sigma_x=" in line]
    want = line_values(eager_lines[0]) if len(eager_lines) == 1 else {}
    errors = []
    for line in replay_lines:
        got = line_values(line)
        if sorted(got) != sorted(want) or got.get("step") != want.get("step"):
            raise AssertionError(f"J9: replayed line {line!r} against eager {eager_lines}")
        errors.append(max(abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-300)
                          for k, v in want.items() if k != "step"))
    print(f"J9: graphed batched_step with log_metrics at B={SWEEP_BATCH}: {len(replay_lines)}"
          f" lines for 3 replays, equal to the eager line: {replay_lines == eager_lines * 3}"
          f" (largest relative difference {max(errors) if errors else float('nan'):.2e},"
          f" bound {METRIC_RTOL}); eager line {eager_lines}; a step: graphed"
          f" {ms['graphed']:.4f} ms, eager {ms['eager']:.4f} ms (CUDA events, {J_STEP_CALLS}"
          f" calls; lines logged after the replay, asynchronously); a graphed PPO update with"
          f" that env logged {per_update} lines (expected {PPO_ROLLOUT} an update; the second"
          f" flushed by graphs.release()); a process replaying a graphed step 3 times and"
          f" exiting without a flush logged {len(exit_lines)} lines (rc {at_exit.returncode});"
          f" card {card}")
    if len(replay_lines) != 3 or max(errors) > METRIC_RTOL:
        raise AssertionError("J9: the replays' metric lines differ from the eager line")
    if per_update != [PPO_ROLLOUT] * 2:
        raise AssertionError(f"J9: a graphed PPO update logged {per_update} lines")
    if at_exit.returncode != 0 or len(exit_lines) != 3 or not all(
            line.startswith("step=1 ") for line in exit_lines):
        raise AssertionError(f"J9: the lines pending at exit were lost: {out!r} {err[-2000:]!r}")


def moment_plan(torch, fused, elements, B, dtype):
    """``plan_of`` inside a graph: the energy filled on the device."""
    return fused.particle_moment_plan(
        elements, torch.full((), 1.073e8, dtype=dtype, device="cuda"),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )


def path_jit_moments(torch, ltt, ft, hist, fused, graphs, envs, ParticleBeam, card):
    """J10: kernels B5 and B6 captured for the first time.  Graphed
    ``env.batched_particle_beam_parameters(method="kernel")`` over path K's
    shared MOMENT_PARTICLES cloud at B = 8 (B5) and 256 (B6), and graphed
    ``sweep_particle_moments`` over path A's aperture lattice at the same
    B: each replay against the eager call (predicted equal; else within
    path K's KERNEL_OBS_RTOL), the graph's B5 and B6 kernel nodes and its
    memset nodes (DOT dump), ms a call replayed and eager.  Returns the B5
    and B6 launches issued."""
    env = envs.make_env(device="cuda")
    beam = moment_cloud(torch, ParticleBeam, MOMENT_PARTICLES, seed=81)
    particles = beam.particles[0]
    weights = torch.ones(MOMENT_PARTICLES, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(83)
    observe = graphs.graphed(lambda m, b: env.batched_particle_beam_parameters(m, b, "kernel"))

    def sweep(elements, particles, weights):
        entries, scalars = moment_plan(torch, fused, elements, elements[1].k1.shape[0],
                                       particles.dtype)
        return ft.sweep_particle_moments(entries, scalars, particles, weights)

    swept = graphs.graphed(sweep)
    issued, worst = {"B5": 0, "B6": 0}, 0.0
    for B in reversed(ENV_KERNEL_BATCHES):
        route = "B6" if B >= ft._PACK_SETTINGS else "B5"
        name = "packed_gram_kernel" if route == "B6" else "moment_walk_kernel"
        magnets = torch.rand((B, 5), generator=gen, device="cuda") - 0.5
        elements = aperture_lattice(torch, ltt, B, "rect", torch.float32)
        for label, jitted, args, eager in (
            ("env kernel route", observe, (magnets, beam),
             lambda: env.batched_particle_beam_parameters(magnets, beam, method="kernel")),
            ("path A's aperture lattice", swept, (elements, particles, weights),
             lambda: sweep(elements, particles, weights)),
        ):
            reset_counts(ft, hist)
            got = jitted(*args)
            torch.cuda.synchronize()
            launched = counts(ft)
            issued["B5"] += launched["B5"]
            issued["B6"] += launched["B6"]
            again = jitted(*args)
            want = eager()
            got = got if isinstance(got, tuple) else (got,)
            again = again if isinstance(again, tuple) else (again,)
            want = want if isinstance(want, tuple) else (want,)
            equal = all(torch.equal(a, b) for a, b in zip(got + again, want + want))
            error = max(relative_gap(torch, [a], [b]) for a, b in zip(got + again, want + want))
            worst = max(worst, error)
            graph = jitted.graphs[-1]
            nodes = graphs.graph_kernel_count(graph, name)
            memsets = graphs.graph_kernel_count(graph, kind="MEMSET")
            kernels = graphs.graph_kernel_count(graph)
            replay_ms = cuda_ms(lambda: jitted(*args), iters=J_STEP_CALLS)
            eager_ms = cuda_ms(eager, iters=J_STEP_CALLS)
            print(f"J10 B={B} {label}: {route} captured ({name} nodes {nodes}, memset nodes"
                  f" {memsets}, kernel nodes {kernels}; DOT dump), the replays equal to the eager"
                  f" call: {equal} (largest difference {error:.3e} of each output's largest"
                  f" |value|, bound {KERNEL_OBS_RTOL}); launches issued {launched}; a call:"
                  f" replay {replay_ms:.4f} ms, eager {eager_ms:.4f} ms (CUDA events,"
                  f" {J_STEP_CALLS} calls); card {card}")
            if nodes != 1 or launched[route] < 1 or error > KERNEL_OBS_RTOL:
                raise AssertionError(f"J10 B={B} {label}: the captured {route} failed its check")
    return issued, worst


def path_jit_parallel(torch, ltt, ares, ft, hist, functional, graphs, tuning, parallel,
                      multichip_tuning, m, seg1, beam1, card):
    """J11: the parallel layer captured, on path M's 1 x 1 mesh in its
    one-rank NCCL world: (a) the flagship read through ``track_jit`` inside
    the mesh (its particle all-reduces in the graph) and (a') path P's push
    through a graphed ``Segment.track`` (B2), against eager inside the mesh
    and the unsharded call (equal);
    (b) path M's train step (``make_tuning_train_step``, graph=True) at
    SWEEP_BATCH settings for TRAIN_MESH_STEPS steps against the same step
    eager with the same capturable Adam (equal), against the unsharded
    tuner run eagerly with that capturable Adam (losses OBS_RTOL, final
    settings GRAD_RTOL: path M (b)'s bounds) and its losses against path M
    (b)'s unsharded tuner with the default Adam (OBS_RTOL), ms a step of
    each form; (c) a
    one-stage ``pipeline_track`` graphed against eager (equal); (d)
    ``multichip_tuning`` graphed against path M (e)'s eager run (OBS_RTOL).
    A one-rank all-reduce launches no NCCL kernel: this proves the
    collectives' insertion in the graphs and equality, not bandwidth.
    Returns the launches issued."""
    from lynx_tpu_torch import _collectives

    mesh, issued = m["mesh"], {}
    # (a) the flagship read through track_jit, (a') path M's push through a
    # graphed Segment.track (the route that launches B2).
    segment, beam, _ = push_path_beam(torch, ares, ltt.ParticleBeam, PUSH_BATCH, PUSH_PARTICLES,
                                      seed=43)
    pushed = graphs.graphed(lambda s, b: s.track(b))
    for label, seg, make_beam, jit, eager in (
        ("a, the flagship read through track_jit", seg1, lambda: beam1,
         lambda s, b: functional.track_jit(s, b)[1]["AREABSCR1"],
         lambda s, b: functional.track(s, b)[1]["AREABSCR1"]),
        ("a', the push through a graphed Segment.track", parallel.shard_segment(segment, mesh),
         lambda: beam, lambda s, b: pushed(s, b).particles, lambda s, b: s.track(b).particles),
    ):
        reset_counts(ft, hist)
        hist.window_histogram.launches = 0
        with torch.no_grad():
            unsharded = eager(seg, make_beam())
            with mesh:
                before = _collectives.counts["all_reduce"]
                jitted = jit(seg, parallel.shard_beam(make_beam(), mesh))
                inserted = _collectives.counts["all_reduce"] - before
                in_mesh = eager(seg, parallel.shard_beam(make_beam(), mesh))
                again = jit(seg, parallel.shard_beam(make_beam(), mesh))
            torch.cuda.synchronize()
        launched = counts(ft)
        launched["B1"] = hist.window_histogram.launches
        for k, v in launched.items():
            issued[k] = issued.get(k, 0) + v
        equal = all(torch.equal(x, in_mesh) for x in (jitted, again, unsharded))
        print(f"J11 ({label}): inside the mesh equal to eager inside the mesh and to the"
              f" unsharded call: {equal}; all-reduces issued while capturing {inserted}"
              f" (warm-ups and capture; the read's particle sums, none in a push); launches"
              f" issued {launched}; card {card}")
        if not equal or (label.startswith("a,") and inserted < 1):
            raise AssertionError(f"J11 ({label}): the captured call differs or holds no all-reduce")
    if issued["B1"] < 1 or issued["B2"] < 1:
        raise AssertionError(f"J11 (a, a'): the captures skipped B1 or B2: {issued}")

    # (b) the train step, captured with its two all-reduces.
    def train(graph, capturable=True):
        segment = parallel.shard_segment(m["subcell"](), mesh)
        m["tuned"](segment)
        optimizer = m["adam"](segment)
        for group in optimizer.param_groups:
            group["capturable"] = capturable
        step = parallel.make_tuning_train_step(optimizer, m["loss_fn"], graph=graph)
        beam = parallel.shard_beam(m["beam"], mesh)
        losses = []
        with mesh:
            for _ in range(TRAIN_MESH_STEPS):
                segment, loss = step(segment, beam)
                losses.append(loss)
        torch.cuda.synchronize()
        return torch.stack(losses), m["tuned"](segment), lambda: step(segment, beam)

    reset_counts(ft, hist)
    before = _collectives.counts["all_reduce"]
    losses, params, graphed_step = train(True)
    inserted = _collectives.counts["all_reduce"] - before
    launched = counts(ft)
    eager_losses, eager_params, eager_step = train(False)
    equal = torch.equal(losses, eager_losses) and all(
        torch.equal(a, b) for a, b in zip(params, eager_params))
    loss_error = relative_error(torch, losses, m["losses"], per_setting=False)
    # The unsharded tuner, eager, with the captured step's Adam (capturable).
    segment = m["subcell"]()
    m["tuned"](segment)
    optimizer = m["adam"](segment)
    graphs.make_capturable(optimizer)
    unsharded_losses = tuning.make_tuner(optimizer, m["loss_fn"], graph=False)(
        segment, TRAIN_MESH_STEPS, m["beam"])[1]
    unsharded_loss_error = relative_error(torch, losses, unsharded_losses, per_setting=False)
    setting_error = max(relative_error(torch, a.detach(), b.detach(), per_setting=False)
                        for a, b in zip(params, m["tuned"](segment)))
    ms = {"eager": [], "graphed": []}
    with mesh:
        for mode in ("eager", "graphed", "graphed", "eager"):
            ms[mode].append(cuda_ms(graphed_step if mode == "graphed" else eager_step,
                                    iters=J_STEP_CALLS))
    for k in ("B3", "B4"):
        issued[k] = issued.get(k, 0) + launched[k]
    print(f"J11 (b, the train step): {TRAIN_MESH_STEPS} steps at B={SWEEP_BATCH} captured inside"
          f" the mesh (all-reduces issued while capturing and replaying {inserted}): equal to the"
          f" eager step with the same capturable Adam: {equal}; against the unsharded tuner"
          f" run eagerly with that Adam: losses {unsharded_loss_error:.2e} (bound {OBS_RTOL}),"
          f" final settings {setting_error:.2e} of the largest |value| (bound {GRAD_RTOL});"
          f" against path M (b)'s unsharded tuner (the default Adam): losses {loss_error:.2e}"
          f" (bound {OBS_RTOL}); a step: graphed {ms['graphed'][0]:.4f} /"
          f" {ms['graphed'][1]:.4f} ms, eager {ms['eager'][0]:.4f} / {ms['eager'][1]:.4f} ms"
          f" (CUDA events, {J_STEP_CALLS} steps a turn, in turns); launches issued {launched};"
          f" card {card}")
    if (not equal or max(loss_error, unsharded_loss_error) > OBS_RTOL
            or setting_error > GRAD_RTOL):
        raise AssertionError("J11 (b): the captured train step differs")
    if launched["B3"] < 1 or launched["B4"] < 1:
        raise AssertionError("J11 (b): the captured train step skipped B3 or B4")

    # (c) the pipeline, graphed.
    segment = ares.ares_ea_segment(device="cuda")
    segment.AREABSCR1.is_active = False
    stages = parallel.split_into_stages(segment, 1)
    outs = [parallel.pipeline_track(stages, m["pipe_beam"], m["pipe_mesh"], 4, graph=graph)
            for graph in (True, True, False)]
    equal = all(torch.equal(a, b) for out in outs[:2] for a, b in
                zip((out._mu, out._cov), (outs[2]._mu, outs[2]._cov)))
    print(f"J11 (c, pipeline_track): one stage, 4 microbatches, graphed (captured once, replayed)"
          f" equal to eager: {equal}; card {card}")
    if not equal:
        raise AssertionError("J11 (c): the graphed pipeline differs from eager")

    # (d) the example, graphed.
    start = time.perf_counter()
    result = multichip_tuning.main(steps=30, device="cuda")
    seconds = time.perf_counter() - start
    errors = [relative_error(torch, torch.tensor(result[k]), torch.tensor(m["example"][k]),
                             per_setting=False) for k in ("losses", "tuner_losses")]
    print(f"J11 (d, multichip_tuning graphed): loss {result['losses'][0]:.4e} ->"
          f" {result['losses'][-1]:.4e}; against path M (e)'s eager run: train step {errors[0]:.2e},"
          f" tuner {errors[1]:.2e} (bound {OBS_RTOL}); {seconds:.2f} s (host clock); card {card}")
    if not result["losses"][-1] < result["losses"][0] or max(errors) > OBS_RTOL:
        raise AssertionError("J11 (d): the graphed example differs from the eager one")
    return issued


def path_jit_aperture(torch, ltt, ares, ft, hist, functional, graphs, card):
    """J12: F4 on the card: an active aperture inside a graph.  A drift, a
    quadrupole with k1 per setting, a 3e-4 x 4e-4 m aperture and a drift,
    J_APERTURE_PARTICLES particles at B = J_APERTURE_BATCH: ``track_jit``
    and a graphed ``Segment.track`` against eager ``Segment.track``
    (particles, survival: equal), once and after re-tuning k1."""
    kw = dict(device="cuda")
    B = J_APERTURE_BATCH
    segment = ltt.Segment([
        ltt.Drift(torch.tensor([0.3], **kw), **kw),
        ltt.Quadrupole(torch.tensor([0.12], **kw), k1=torch.linspace(-8.0, 8.0, B, **kw), **kw),
        ltt.Aperture(x_max=torch.tensor(3e-4, **kw), y_max=torch.tensor(4e-4, **kw), **kw),
        ltt.Drift(torch.tensor([0.4], **kw), **kw)], name="j12")
    beam = moment_cloud(torch, ltt.ParticleBeam, J_APERTURE_PARTICLES, seed=121).broadcast((B,))
    tracked = graphs.graphed(lambda s, b: s.track(b))
    results = []
    for k1 in (torch.linspace(-8.0, 8.0, B, **kw), torch.linspace(-4.0, 6.0, B, **kw)):
        segment.elements[1].k1 = k1
        with torch.no_grad():
            want = segment.track(beam)
            pairs = ((functional.track_jit(segment, beam)[0], functional.track(segment, beam)[0]),
                     (tracked(segment, beam), want))
        equal = all(torch.equal(o.particles, w.particles) and torch.equal(o.survival, w.survival)
                    for o, w in pairs)
        results.append((equal, int(want.survival.sum(dim=-1).min()),
                        int(want.survival.sum(dim=-1).max())))
    print(f"J12: an active aperture captured (track_jit and graphed Segment.track, {B} settings x"
          f" {J_APERTURE_PARTICLES} particles): replays equal to eager Segment.track (particles,"
          f" survival) [equal, fewest, most survivors] {results}; captures: track_jit"
          f" {functional.track_jit.graphed.captures}, Segment.track {tracked.captures}; card {card}")
    if not all(r[0] for r in results) or tracked.captures != 1:
        raise AssertionError("J12: the captured aperture differs from eager")


def path_jit_examples(torch, ares, ParticleBeam, functional, graphs, profiling, image_tuning,
                      emittance_measurement, optimize_speed, eager_stages, card):
    """J13: the examples' own jits as graphs: image_tuning's loss and
    gradient (forward and backward captured, 200 steps, the loss must
    collapse as the JAX example asserts); emittance_measurement's measure
    against eager (equal); optimize_speed's stages replayed, with their
    capture seconds, beside path O's eager stages, each replay's outgoing
    beam equal to path O's; profiling.benchmark through a graph against
    graph=False, the graph's value equal to the eager read's."""
    start = time.perf_counter()
    params, losses = image_tuning.main(device="cuda")
    image_s = time.perf_counter() - start
    print(f"J13 image_tuning graphed: loss {float(losses[0]):.3e} -> {float(losses[-1]):.3e}"
          f" (collapsed below 1e-3 of the first), k = {[round(x, 4) for x in params.tolist()]};"
          f" {image_s * 1000.0 / 200:.4f} ms per tune step (the example's wall time over 200"
          f" steps, captures included, host clock); card {card}")
    results = {graph: emittance_measurement.main(device="cuda", graph=graph)
               for graph in (True, False)}
    equal = torch.equal(results[True]["measured"], results[False]["measured"])
    print(f"J13 emittance_measurement: the graphed measure equal to eager: {equal}; fitted"
          f" emittance {results[True]['emittance']:.5e} against {results[True]['true_emittance']:.5e}"
          f" m rad; card {card}")
    if not equal:
        raise AssertionError("J13: the graphed measurement differs from eager")
    stages = optimize_speed.main(OPTIMIZE_CELLS, OPTIMIZE_BATCH, device="cuda",
                                 iters=OPTIMIZE_ITERS)
    stages_equal = [torch.equal(beam._mu, eager._mu) and torch.equal(beam._cov, eager._cov)
                    for (_, _, beam, _), (_, _, eager, _) in zip(stages, eager_stages)]
    print("J13 optimize_speed replayed: " + ", ".join(
        f"{label} {seconds * 1e3:.4f} ms (capture {capture:.3f} s)"
        for label, seconds, _, capture in stages)
        + f" a track (CUDA events, profiling.benchmark, {OPTIMIZE_ITERS} replays); each replay's"
        f" outgoing beam equal to path O's eager track: {stages_equal}; card {card}")
    segment, beam = flagship(torch, ares, ParticleBeam, 1, "cuda", seed=0)

    def read(segment, beam):
        return functional.track(segment, beam)[1]["AREABSCR1"]

    jitted = graphs.graphed(read)
    seconds = {graph: profiling.benchmark(jitted if graph else read, segment, beam, iters=20,
                                          graph=graph) for graph in (True, False)}
    read_equal = torch.equal(jitted(segment, beam), read(segment, beam))
    print(f"J13 profiling.benchmark of the flagship read: through a graph {seconds[True] * 1e3:.4f}"
          f" ms, graph=False {seconds[False] * 1e3:.4f} ms a call (CUDA events, 20 calls); the"
          f" graph's image equal to the eager read's: {read_equal}; card {card}")
    if not seconds[True] > 0 or any(seconds <= 0 for _, seconds, _, _ in stages):
        raise AssertionError("J13: a benchmark returned no positive time")
    if not all(stages_equal) or not read_equal:
        raise AssertionError("J13: a replay differs from its eager form")


def ptxas_report(log):
    """``kernel<args> R registers, S/L bytes spilled`` for each kernel of an
    nvcc -Xptxas -v report (spill stores / spill loads); template arguments
    decoded from the mangled name (float, double, a bool, an int): B3's are
    <T, kFull>, B4's <T, kFull, kSegmented>."""
    import re

    words = {"f": "float", "d": "double", "Lb0E": "false", "Lb1E": "true"}
    found = []
    for chunk in log.split("Compiling entry function")[1:]:
        name = re.match(r" '\w*?([a-z][a-z_]*_kernel)(?:I((?:[fd]|L[bi]\d+E)+)E)?", chunk)
        registers = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if name and registers:
            args = re.findall(r"[fd]|L[bi]\d+E", name[2] or "")
            args = [words.get(a, a[2:-1]) for a in args]
            spilled = (f"{spills[1]}/{spills[2]} bytes spilled" if spills
                       else "spills not reported")
            found.append(f"{name[1]}{'<' + ', '.join(args) + '>' if args else ''}"
                         f" {registers[1]} registers, {spilled}")
    return "; ".join(found)


def main():
    import torch

    # -- 1. the card -------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: cuda.matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)  # name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    import lynx_tpu_torch as ltt
    from lynx_tpu_torch import (ParticleBeam, _build, debug, envs, functional, graphs, metrics,
                                profiling, tuning)
    from lynx_tpu_torch.accelerator import fused
    from lynx_tpu_torch.accelerator import segment as segment_module
    from lynx_tpu_torch.benchmarks import hist_ab
    from lynx_tpu_torch import parallel
    from lynx_tpu_torch.examples import (
        emittance_measurement,
        gradient_tuning,
        image_tuning,
        multichip_tuning,
        optimize_speed,
        particle_fidelity_sweep,
        ppo_ares_ea,
    )
    from lynx_tpu_torch.models import ares
    from lynx_tpu_torch.ops import fused_track as ft
    from lynx_tpu_torch.ops import histogram as hist
    from lynx_tpu_torch.ops import table as tbl

    # -- 2. build ----------------------------------------------------------
    start = time.perf_counter()
    _build.build_libraries(KERNEL_LIBRARIES)
    for load in (hist.window_histogram_library, ft.particle_apply_library,
                 ft.moment_sweep_library, ft.moment_sweep_bwd_library,
                 ft.particle_moment_sweep_library, ft.packed_gram_library,
                 hist_ab.hist_ab_library):
        load()
    print(f"build: {', '.join(KERNEL_LIBRARIES)} (one nvcc each, in parallel) in"
          f" {time.perf_counter() - start:.2f} s")
    for name, (seconds, log) in _build.BUILD_LOG.items():
        print(f"build {name}: {seconds:.2f} s; ptxas: {ptxas_report(log)}")

    # -- 3. kernels against their plain versions ----------------------------
    max_abs_err = check_kernel_cases(torch, hist)
    max_abs_err = max(max_abs_err, check_read_cases(torch, hist, card))
    env = envs.make_env(device="cuda")
    sweep_abs_err = check_sweep_kernels(torch, ltt, ft, fused, env)
    push_abs_err = check_push_kernel(torch, ft, fused, tbl)
    moment_abs_err = check_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam)
    check_long_tape(torch, ft, fused, tbl, card)

    # -- 4. the main path ---------------------------------------------------
    seg1, beam1 = flagship(torch, ares, ParticleBeam, 1, "cuda", seed=0)
    seg8, beam8 = flagship(torch, ares, ParticleBeam, 8, "cuda", seed=8)
    hist.window_histogram.launches = 0
    hist.reset_histogram_fallback_count()
    _, diagnostics = functional.track(seg1, beam1)
    image1 = diagnostics["AREABSCR1"]
    seg1.track(beam1)
    image1_stateful = seg1.AREABSCR1.reading
    _, diagnostics = functional.track(seg8, beam8)
    image8 = diagnostics["AREABSCR1"]
    torch.cuda.synchronize()
    launches = hist.window_histogram.launches
    fallbacks = hist.histogram_fallback_count()
    print(f"main path: B1 launches {launches} over 3 reads ({hist.READ_LAUNCHES} a read),"
          f" scatter fallbacks {fallbacks}")
    if launches != 3 * hist.READ_LAUNCHES or fallbacks != 0:
        raise AssertionError("the main path did not go through kernel B1 on every read")
    if not torch.equal(image1, image1_stateful):
        raise AssertionError("functional.track and Segment.track + reading disagree")

    for label, image, segment, beam, batch in (
        ("B=1", image1, seg1, beam1, 1),
        ("B=8", image8, seg8, beam8, 8),
    ):
        if tuple(image.shape) != (batch, 2040, 2448) or not bool(torch.isfinite(image).all()):
            raise AssertionError(f"{label}: bad image {tuple(image.shape)}")
        masses = image.sum(dim=(-2, -1)).tolist()
        if masses != [float(N_PARTICLES)] * batch:
            raise AssertionError(f"{label}: image mass {masses}, expected {N_PARTICLES}")
        segment_cpu = copy.deepcopy(segment).to("cpu")
        _, diagnostics = functional.track(segment_cpu, beam.to("cpu"))
        image_cpu = diagnostics["AREABSCR1"]
        if image_cpu.sum(dim=(-2, -1)).tolist() != masses:
            raise AssertionError(f"{label}: CPU image mass differs")
        l1 = (image.cpu() - image_cpu).abs().sum(dim=(-2, -1)).tolist()
        print(f"{label}: image {tuple(image.shape)} mass {masses[0]:.0f} per row;"
              f" against the CPU path L1 per row {l1}"
              f" ({sum(l1) / 2:.0f} particles moved a bin in all)")
        if max(l1) > 2 * MAX_MOVED:
            raise AssertionError(f"{label}: GPU and CPU images differ by L1 {l1}")

    # -- 5. times ------------------------------------------------------------
    rates = {}
    for label, segment, beam, batch in (("B=1", seg1, beam1, 1), ("B=8", seg8, beam8, 8)):
        ms = cuda_ms(lambda: functional.track(segment, beam), iters=50)
        rates[label] = batch * 1000.0 / ms
        print(f"flagship track + read {label}: {ms:.4f} ms/call, {rates[label]:.1f} tracks/s"
              f" (CUDA events, 50 calls after warm-up; card {card})")

    read_args = {"B=1": screen_read_args(seg1, beam1), "B=8": screen_read_args(seg8, beam8)}
    args = read_args["B=1"]
    window = hist._window_shape(args["window"], *args["bins"])
    if window != WINDOW:
        raise AssertionError(f"flagship window {window}, expected {WINDOW}")
    read_timing = {label: time_read(torch, hist, a, card, label) for label, a in read_args.items()}
    flagship_kernels = {}
    for route in ("fused", "composed"):
        with composed_route(hist, route == "composed"):
            flagship_kernels[route] = device_kernels(
                device_launches(lambda: functional.track(seg1, beam1)))
    print(f"flagship call (functional.track, B=1): {flagship_kernels['fused']} device kernels"
          f" with the fused read, {flagship_kernels['composed']} with the composed read"
          f" (torch.profiler; memsets counted, copies not; card {card})")

    # B1's row at the flagship read (B=1): the fused read's call time and
    # its plain version's on the same CUDA operands (CUDA events, as every
    # row's ms), its bound (x, y and weights read once, the window written
    # once) and the one PyTorch call of the histogram, torch.bincount of the
    # live particles' image cells.  B1's device time is printed beside them.
    x, y, w = args["x"], args["y"], args["weights"]
    ranges = (*args["x_range"], *args["y_range"])
    bins = args["bins"]
    read_ms = cuda_ms(lambda: hist.windowed_read(x, y, w, ranges, bins, window, True), iters=50)
    plain_ms = cuda_ms(lambda: plain_read(hist, x, y, w, ranges, bins, window, True), iters=50)
    b1_bound = bound(nbytes(x, y, w) + window[0] * window[1] * w.element_size(), x.numel())
    ix, vx = hist._bin_index(x, *args["x_range"], bins[0])
    iy, vy = hist._bin_index(y, *args["y_range"], bins[1])
    flat = (ix.long() * bins[1] + iy.long())[vx & vy & (w != 0)]
    bincount_ms = cuda_ms(lambda: torch.bincount(flat, minlength=bins[0] * bins[1]), iters=200)
    print(f"B1 at the flagship read (B=1): the read (three launches) {read_ms:.4f} ms a call (CUDA"
          f" events, 50 calls), its kernels {read_timing['B=1']['kernel_ms']:.5f} ms of device"
          f" time a read (previous design's count core {PARENT_DEVICE_MS['B1']:.5f} ms, PERF.md);"
          f" plain version {plain_ms:.4f} ms a call (CUDA events); bound"
          f" {b1_bound[0]:.5f} ms ({b1_bound[1]}); torch.bincount over the image"
          f" {bincount_ms:.5f} ms a call (CUDA events, 200 calls; card {card})")

    # -- 6. the batched-settings paths ---------------------------------------
    serving_launches = path_serving(torch, ft, hist, envs, env, card)
    training_launches = path_training(torch, ft, hist, envs, env, tuning, card)
    push_launches = path_particles(torch, ft, hist, segment_module, ares, ParticleBeam, card)
    timing = time_kernels(torch, ft, fused, tbl, env, card)

    # -- 7. the particle moment sweep ------------------------------------------
    walk_launches, env_gram_launches = path_env_kernel(torch, ft, hist, env, ParticleBeam, card)
    aperture_gram_launches = path_aperture_sweep(torch, ltt, ft, hist, fused, functional,
                                                 ParticleBeam, card)
    crossover(torch, ltt, ft, fused, ParticleBeam, card)
    timing.update(time_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam, card))

    # -- 8. the full ARES lattice and kernel B7 ---------------------------------
    path_lattice_read(torch, ares, functional, hist, ParticleBeam, ltt.ParameterBeam, card)
    path_lattice_sweep(torch, ltt, ares, ft, fused, hist, functional, segment_module, card)
    hist_launches, hist_timing, hist_abs_err = path_hist_ab(torch, hist, card)

    # -- 9. path I, the beam and lattice I/O slice -------------------------------
    io_launches = {"B1": path_io_astra(torch, ltt, ares, functional, hist, card)}
    io_launches["B1"] += path_io_nx_read(torch, ltt, functional, hist, card)
    io_launches.update(path_io_nx_sweep(torch, ltt, ft, fused, hist, functional, segment_module,
                                        card))
    print(f"path I: launches {io_launches}")

    # -- 10. path R, the RL-training and tuning slice ----------------------------
    rl_launches, env_state, r1 = path_rl_ppo(torch, ft, hist, envs, ppo_ares_ea, profiling,
                                             card)
    path_rl_metrics(torch, envs, env_state, card)
    path_rl_tuning(torch, gradient_tuning, emittance_measurement, image_tuning, card)
    fidelity_launches, fidelity_beams = path_rl_fidelity(torch, ft, hist,
                                                         particle_fidelity_sweep, card)
    path_rl_debug(torch, functional, debug, env_state, fidelity_beams)
    rl_launches = {
        "B3": rl_launches["B3"],
        "B5": sum(launched["B5"] for launched in fidelity_launches.values()),
        "B6": sum(launched["B6"] for launched in fidelity_launches.values()),
    }
    print(f"path R: launches {rl_launches}")

    # -- 11. path O, the optimize_speed example -----------------------------------
    optimize_launches, optimize_stages = path_optimize_speed(torch, ltt, ft, hist, segment_module,
                                                             optimize_speed, card)

    # -- 12. path M, the parallel layer on a 1 x 1 mesh -----------------------------
    mesh_launches, m_context = path_parallel(torch, ltt, ares, ft, hist, fused, functional,
                                             tuning, parallel, multichip_tuning, seg1, beam1,
                                             card)
    print(f"path O: launches {optimize_launches}; path M: launches {mesh_launches}")

    # -- 13. path V, random element mixes ------------------------------------------
    start = time.perf_counter()
    golden_launches = path_v_golden(torch, ltt, ft, hist, card)
    random_launches = path_v_sweep(torch, ltt, ft, hist, fused, functional, segment_module,
                                   card)
    random_launches["B2"] = golden_launches + path_v_push(torch, ltt, ft, hist, segment_module,
                                                          card)
    random_launches.update(path_v_moments(torch, ltt, ft, hist, fused, functional, ParticleBeam,
                                          card))
    random_launches["B1"] = path_v_read(torch, ltt, ft, hist, functional, card)
    print(f"path V: launches {random_launches} in {time.perf_counter() - start:.1f} s"
          f" (host clock, V1-V5)")

    # -- 14. path J, the compiled entry points as CUDA graphs -------------------------
    start = time.perf_counter()
    jit_launches = {"B1": path_jit_read(torch, ares, functional, graphs, hist, ParticleBeam,
                                        card)}
    fallback_launches, fallback_abs_err = path_jit_fallback(torch, ares, functional, hist,
                                                            ParticleBeam, card)
    jit_launches["B1"] += fallback_launches
    max_abs_err = max(max_abs_err, fallback_abs_err)
    jit_launches["B3"] = jit_launches["B4"] = 0
    path_jit_float64_adam(torch, ltt, functional, tuning, card)
    for launched in (path_jit_tuner(torch, ft, hist, envs, env, tuning, card),
                     path_jit_until(torch, ft, hist, envs, env, tuning, card),
                     path_jit_cavities(torch, ltt, ft, hist, functional, graphs, card),
                     path_jit_grad(torch, ft, hist, envs, env, functional, card)):
        jit_launches["B3"] += launched["B3"]
        jit_launches["B4"] += launched["B4"]
    path_jit_gym(torch, envs, card)
    print(f"path J: launches issued {jit_launches} (warm-ups and captures; a replay issues none"
          f" from the host) in {time.perf_counter() - start:.1f} s (host clock, J1-J7)")

    # -- 15. path J, continued: the last jitted sites (J8-J13) --------------------------
    start = time.perf_counter()
    jit_launches["B3"] += path_jit_ppo(torch, ft, hist, graphs, envs, ppo_ares_ea, r1, card)
    path_jit_metrics(torch, graphs, envs, ppo_ares_ea, metrics, r1, card)
    moment_launches, moment_worst = path_jit_moments(torch, ltt, ft, hist, fused, graphs, envs,
                                                     ParticleBeam, card)
    jit_launches.update(moment_launches)
    parallel_launches = path_jit_parallel(torch, ltt, ares, ft, hist, functional, graphs, tuning,
                                          parallel, multichip_tuning, m_context, seg1, beam1,
                                          card)
    for k, v in parallel_launches.items():
        jit_launches[k] = jit_launches.get(k, 0) + v
    import torch.distributed as dist

    graphs.release()  # NCCL keeps a communicator while a graph holds its collectives
    dist.destroy_process_group()
    path_jit_aperture(torch, ltt, ares, ft, hist, functional, graphs, card)
    path_jit_examples(torch, ares, ParticleBeam, functional, graphs, profiling, image_tuning,
                      emittance_measurement, optimize_speed, optimize_stages, card)
    print(f"path J: launches issued {jit_launches} (J1-J13) in {time.perf_counter() - start:.1f}"
          f" s (host clock, J8-J13); the largest replay-against-eager difference of B5/B6's"
          f" captures {moment_worst:.3e}")

    # -- 16. results ---------------------------------------------------------
    timing["B1"] = dict(ms=read_ms, plain_ms=plain_ms, bound=b1_bound,
                        library_ms=bincount_ms)
    timing["B7 onehot"], timing["B7 twolevel"] = hist_timing["onehot"], hist_timing["twolevel"]
    kernels = []
    for name, label, source, replaces, launched, error in (
        ("window_histogram", "B1", "window_histogram.cu", "lynx_tpu/ops/histogram.py:250",
         launches + mesh_launches["B1"] + random_launches["B1"] + jit_launches["B1"],
         max_abs_err),
        ("particle_apply", "B2", "particle_apply.cu", "lynx_tpu/ops/pallas_track.py:1439",
         push_launches["B2"] + mesh_launches["B2"] + random_launches["B2"]
         + jit_launches.get("B2", 0), push_abs_err),
        ("moment_sweep", "B3", "moment_sweep.cu", "lynx_tpu/ops/pallas_track.py:72",
         serving_launches["B3"] + rl_launches["B3"] + optimize_launches["B3"]
         + mesh_launches["B3"] + random_launches["B3"] + jit_launches["B3"], sweep_abs_err["B3"]),
        ("moment_sweep_bwd", "B4", "moment_sweep_bwd.cu", "lynx_tpu/ops/pallas_track.py:249",
         training_launches["B4"] + mesh_launches["B4"] + random_launches["B4"]
         + jit_launches["B4"], sweep_abs_err["B4"]),
        ("particle_moment_sweep", "B5", "particle_moment_sweep.cu",
         "lynx_tpu/ops/pallas_track.py:633",
         walk_launches + rl_launches["B5"] + random_launches["B5"] + jit_launches["B5"],
         moment_abs_err["B5"]),
        ("packed_gram", "B6", "packed_gram.cu", "lynx_tpu/ops/pallas_track.py:823",
         env_gram_launches + aperture_gram_launches + rl_launches["B6"] + mesh_launches["B6"]
         + random_launches["B6"] + jit_launches["B6"], moment_abs_err["B6"]),
        ("hist_onehot", "B7 onehot", "hist_ab.cu", "benchmarks/hist_ab.py:94",
         hist_launches["onehot"], hist_abs_err),
        ("hist_twolevel", "B7 twolevel", "hist_ab.cu", "benchmarks/hist_ab.py:50",
         hist_launches["twolevel"], hist_abs_err),
    ):
        t = timing[label]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"lynx_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": error,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
        })
    print(f"torch.profiler sessions (benchmarks/timing.py): {PROFILER_TALLY['whole']} whole,"
          f" {PROFILER_TALLY['taken again']} taken again; a whole one lost at most"
          f" {PROFILER_TALLY['most lead markers lost']} of its lead markers; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
