#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``lynx_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. require a CUDA device, pin TF32 off, print the card and its power limit;
2. build kernel B1 (``lynx_tpu_torch/csrc/window_histogram.cu``) with nvcc;
3. hold B1 against its plain PyTorch version on the card at the flagship
   shapes and at the edge cases (count mode exactly equal, weighted mode
   within 1e-5 relative of the plain version in float64);
4. drive the main path, the ARES EA track of a 100k-particle beam and the
   2448 x 2040 read of screen AREABSCR1, at B = 1 (``functional.track`` and
   ``Segment.track`` + ``reading``) and B = 8; check the images, that B1
   served every read and that no read fell back, and hold the images
   against the port's CPU path on the same particles;
5. time the flagship read and B1 with CUDA events;
6. print the kernels' JSON line and, last, the ``{"ok": true, ...}`` line.

It imports neither JAX nor ``lynx_tpu``.
"""

import copy
import json
import subprocess
import sys
import time

N_PARTICLES = 100_000
WINDOW = (952, 256)  # the flagship kernel window, after swap and rounding
# Moved particles allowed between the GPU and CPU images: the two sum the
# f32 transfer-map products in other orders, so a particle within an ulp of
# a bin edge may land one bin over (each move adds 2 to the L1 distance).
MAX_MOVED = 20


def time_cuda(torch, fn, iters, warmup=3):
    """Milliseconds per call of ``fn`` on the device timeline, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(torch, fn, iters):
    """Milliseconds of device kernel time per call of ``fn`` (all kernels it
    issues, summed), from ``torch.profiler``; raises if it traced none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        event.self_device_time_total
        for event in prof.key_averages()
        if event.device_type == torch.autograd.DeviceType.CUDA
    )
    if total_us <= 0:
        raise AssertionError("torch.profiler traced no device time")
    return total_us / iters / 1e3


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

    from lynx_tpu_torch import ParticleBeam, functional
    from lynx_tpu_torch.accelerator.screen import screen_histogram_args
    from lynx_tpu_torch.models import ares
    from lynx_tpu_torch.ops import histogram as hist

    # -- 2. build ----------------------------------------------------------
    start = time.perf_counter()
    hist.window_histogram_library()
    print(f"build: window_histogram in {time.perf_counter() - start:.2f} s")

    # -- 3. kernel against its plain version --------------------------------
    max_abs_err = check_kernel_cases(torch, hist)

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
    print(f"main path: B1 launches {launches}, scatter fallbacks {fallbacks}")
    if launches < 3 or fallbacks != 0:
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
        ms = time_cuda(torch, lambda: functional.track(segment, beam), iters=50)
        rates[label] = batch * 1000.0 / ms
        print(f"flagship track + read {label}: {ms:.4f} ms/call, {rates[label]:.1f} tracks/s"
              f" (CUDA events, 50 calls after warm-up; card {card})")

    screen = seg1.AREABSCR1
    args = screen_histogram_args(
        screen.get_read_beam(),  # stored by seg1.track in phase 4
        screen.resolution,
        screen.pixel_size,
        screen.binning,
        histogram_window=screen.histogram_window,
    )
    window = hist._window_shape(args["window"], *args["bins"])
    if window != WINDOW:
        raise AssertionError(f"flagship window {window}, expected {WINDOW}")
    ranges = (*args["x_range"], *args["y_range"])
    lx, ly, _, _, fits = hist.window_prologue(
        args["x"], args["y"], args["weights"], ranges, args["bins"], window
    )
    if not bool(fits.all()):
        raise AssertionError("the flagship spot does not fit the window")
    kernel_ms = time_cuda(torch, lambda: hist.window_histogram(lx, ly, None, *window), iters=200)
    plain_ms = time_cuda(
        torch, lambda: hist.window_histogram_reference(lx, ly, None, *window), iters=200
    )
    scatter_ms = time_cuda(
        torch,
        lambda: hist.weighted_histogram_2d(
            args["x"], args["y"], args["weights"], args["x_range"], args["y_range"], args["bins"]
        ),
        iters=200,
    )
    print(f"B1 at the flagship read (B=1, N={N_PARTICLES}, window {window}, count mode):"
          f" kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" full-image scatter {scatter_ms:.4f} ms per call (CUDA events, 200 calls"
          f" back to back, host launch cost included; card {card})")
    kernel_device = device_time_ms(
        torch, lambda: hist.window_histogram(lx, ly, None, *window), iters=50
    )
    plain_device = device_time_ms(
        torch, lambda: hist.window_histogram_reference(lx, ly, None, *window), iters=50
    )
    print(f"B1 at the flagship read, device time of the GPU work per call"
          f" (output zeroing included): kernel {kernel_device:.5f} ms,"
          f" plain {plain_device:.5f} ms (torch.profiler, 50 calls; card {card})")

    # -- 6. results ----------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "window_histogram",
        "route": "cuda",
        "source": "lynx_tpu_torch/csrc/window_histogram.cu",
        "replaces": "lynx_tpu/ops/histogram.py:250",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
