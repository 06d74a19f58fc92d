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
   float64); hold B1's fused read (``windowed_read``) against
   ``windowed_read_reference`` on the same CUDA tensors at the flagship's
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
   B1 served every read (two launches a read) and that no
   read fell back, and hold the images against the port's CPU path on the
   same particles;
5. time the flagship track + read with CUDA events; the windowed read's
   device time (all of its GPU work) through the fused read and through
   the composed read (the prologue in PyTorch, B1's count core,
   ``_place``) in turns, beside the full-image scatter, B1's kernels' own time, its bound
   and the read's floor (the image written once), and the device kernels a
   read issues (at most 4) and a flagship call issues;
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
11. print the kernels' JSON line and, last, the ``{"ok": true, ...}`` line.

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

from lynx_tpu_torch.benchmarks.timing import cuda_ms, device_launches, device_ms

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


def flagship(torch, ares, ParticleBeam, batch, device, seed):
    """The flagship segment (screen active, working-point k1) and a
    100k-particle beam for ``batch`` settings."""
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
        sigma_x=torch.full(shape, 1.75e-4),
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


def check_read(torch, hist, label, operands, bins, window, binary):
    """B1's fused read against its plain version on the same CUDA tensors:
    origins and fits equal, the image exact in count mode (within
    READ_RTOL per cell weighted); max |error|."""
    x, y, weights, ranges = operands
    image, ox, oy, fits = hist.windowed_read(x, y, weights, ranges, bins, window, binary)
    ref = hist.windowed_read_reference(x, y, weights, ranges, bins, window, binary)
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
        if not bool(fits.all()):
            hist._note_fallback()
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
    """Path T: tuning.tune of (SWEEP_BATCH, 5) settings for SWEEP_STEPS
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
    with plain_on_cuda_guard(torch, ft) as plain:
        tuned, losses = tuning.tune(loss_fn, start, params, steps=SWEEP_STEPS)
        torch.cuda.synchronize()
    launched = counts(ft)  # the path's own launches, before any timing
    losses = losses.tolist()
    print(f"path T: tune of ({B}, 5) settings, {SWEEP_STEPS} Adam steps: loss {losses[0]:.6e}"
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
    runs, run = [], []
    for element in lattice.flattened().elements:
        if element.is_skippable:
            run.append(element)
        elif run:
            runs.append(run)
            run = []
    runs += [run] if run else []
    plans = []
    for run in runs:
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
    B1: two launches and no fallback, image mass equal to the particle
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
    update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT)
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
    route).  Returns (the launches, R1's env, params and states)."""
    B = SWEEP_BATCH
    env = envs.make_env(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(41)
    params = envs.default_params(gen, device="cuda", batch_shape=(B,))
    policy = ppo.MLPPolicy(env.obs_size, env.num_actions, generator=gen, device="cuda")
    initial_policy = copy.deepcopy(policy)
    optimizer = torch.optim.Adam(policy.parameters(), lr=ppo.LEARNING_RATE)
    update = ppo.make_collect_and_update(env, params, optimizer, PPO_ROLLOUT)
    noise = torch.randn((PPO_ROLLOUT, B, env.num_actions), generator=gen, device="cuda")

    reset_counts(ft, hist)
    with plain_on_cuda_guard(torch, ft) as plain:
        obs, states = env.batched_reset(gen, params)
        magnets = states.magnets.clone()
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
    small_update = ppo.make_collect_and_update(env, small_params, optimizer, PPO_ROLLOUT)
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
    return launched, (env, params, states)


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
        ("image_tuning", lambda: image_tuning.main(device="cuda"), 200),
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
    from lynx_tpu_torch import ParticleBeam, _build, debug, envs, functional, profiling, tuning
    from lynx_tpu_torch.accelerator import fused
    from lynx_tpu_torch.accelerator import segment as segment_module
    from lynx_tpu_torch.benchmarks import hist_ab
    from lynx_tpu_torch.examples import (
        emittance_measurement,
        gradient_tuning,
        image_tuning,
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
    plain_ms = cuda_ms(lambda: hist.windowed_read_reference(x, y, w, ranges, bins, window, True),
                       iters=50)
    b1_bound = bound(nbytes(x, y, w) + window[0] * window[1] * w.element_size(), x.numel())
    ix, vx = hist._bin_index(x, *args["x_range"], bins[0])
    iy, vy = hist._bin_index(y, *args["y_range"], bins[1])
    flat = (ix.long() * bins[1] + iy.long())[vx & vy & (w != 0)]
    bincount_ms = cuda_ms(lambda: torch.bincount(flat, minlength=bins[0] * bins[1]), iters=200)
    print(f"B1 at the flagship read (B=1): the fused read {read_ms:.4f} ms a call (CUDA"
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
    rl_launches, env_state = path_rl_ppo(torch, ft, hist, envs, ppo_ares_ea, profiling, card)
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

    # -- 11. results ---------------------------------------------------------
    timing["B1"] = dict(ms=read_ms, plain_ms=plain_ms, bound=b1_bound,
                        library_ms=bincount_ms)
    timing["B7 onehot"], timing["B7 twolevel"] = hist_timing["onehot"], hist_timing["twolevel"]
    kernels = []
    for name, label, source, replaces, launched, error in (
        ("window_histogram", "B1", "window_histogram.cu", "lynx_tpu/ops/histogram.py:250",
         launches, max_abs_err),
        ("particle_apply", "B2", "particle_apply.cu", "lynx_tpu/ops/pallas_track.py:1439",
         push_launches["B2"], push_abs_err),
        ("moment_sweep", "B3", "moment_sweep.cu", "lynx_tpu/ops/pallas_track.py:72",
         serving_launches["B3"] + rl_launches["B3"], sweep_abs_err["B3"]),
        ("moment_sweep_bwd", "B4", "moment_sweep_bwd.cu", "lynx_tpu/ops/pallas_track.py:249",
         training_launches["B4"], sweep_abs_err["B4"]),
        ("particle_moment_sweep", "B5", "particle_moment_sweep.cu",
         "lynx_tpu/ops/pallas_track.py:633", walk_launches + rl_launches["B5"],
         moment_abs_err["B5"]),
        ("packed_gram", "B6", "packed_gram.cu", "lynx_tpu/ops/pallas_track.py:823",
         env_gram_launches + aperture_gram_launches + rl_launches["B6"], moment_abs_err["B6"]),
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
