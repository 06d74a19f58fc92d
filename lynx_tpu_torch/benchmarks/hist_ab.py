"""The count-histogram A/B on the card (counterpart of the JAX package's
``benchmarks/hist_ab.py``): the variants of kernel B7
(``csrc/hist_ab.cu``) against their plain version, beside kernel B1's count
mode and one ``torch.bincount`` call as yardsticks.

    python3 -m lynx_tpu_torch.benchmarks.hist_ab [--particles N] [--win X,Y] [--variants a,b]

The workload is the flagship screen read's: 100,000 particles in a Gaussian
spot (sigma = win / 8 about the window's centre, clipped into it) over the
(952, 256) kernel window, made from a seeded ``torch.Generator``.  Each
variant is first checked exactly against :func:`hist_ab_reference`, then
timed with CUDA events over many launches and with ``torch.profiler``'s
device time; one JSON line each: ``variant``, ``ms_per_read``, ``win``,
``particles``, ``device_ms``.

Variants: ``onehot_c<chunk>`` (the one-hot contraction on the int8 tensor
cores, ``chunk`` particles staged per step: the TPU kernel's ``tile_n`` /
``halves``) and ``twolevel_b<rows>`` (the window in bands of ``rows`` rows
in shared memory).  The TPU variants' ``compare_dtype`` and ``pretrans``
exist for the TPU's vector lanes and matrix-unit layout and have no
counterpart here.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import Optional, Sequence, Tuple

import torch

from lynx_tpu_torch._build import check, load_library
from lynx_tpu_torch.benchmarks.timing import cuda_ms, device_ms

Tensor = torch.Tensor

#: C signatures of B7's entry points: the counts (lx, ly, out, n, win_x,
#: win_y, chunk or band rows, stream) and the particle splits of a launch.
_B7_SIGNATURE = {
    "lynx_hist_onehot": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ),
    "lynx_hist_twolevel": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ),
    "lynx_hist_onehot_splits": (
        ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    ),
    "lynx_hist_twolevel_splits": (
        ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    ),
}

ONEHOT_CHUNKS = (256, 1024, 2048)
#: The twolevel default, the fastest band of the A/B on an H100: 34 bands of
#: 28 rows of the flagship window, 28 KB of shared memory a block.  The
#: band's height is the question B1's redesign asks of this A/B, so the
#: variants keep 56 and 112 beside it.
BAND_ROWS = 28


def hist_ab_library() -> ctypes.CDLL:
    """Kernel B7's library, built with nvcc at first use."""
    return load_library("hist_ab", _B7_SIGNATURE)


def hist_ab_reference(lx: Tensor, ly: Tensor, win_x: int, win_y: int) -> Tensor:
    """Plain PyTorch version of kernel B7: the ``(1, win_x, win_y)`` int32
    counts of the pairs with ``0 <= lx < win_x`` and ``0 <= ly < win_y``;
    any other pair (a -1 pad, an index outside the window) is dropped."""
    inside = (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < win_y)
    overflow = win_x * win_y  # one bin past the window takes the dropped pairs
    flat = torch.where(inside, lx.long() * win_y + ly.long(), overflow)
    out = torch.zeros(overflow + 1, dtype=torch.int32, device=lx.device)
    out.index_put_((flat,), torch.ones_like(lx, dtype=torch.int32), accumulate=True)
    return out[:overflow].view(1, win_x, win_y)


def _check(what: str, lx: Tensor, ly: Tensor, win_x: int, win_y: int) -> None:
    if not lx.is_cuda or ly.device != lx.device:
        raise ValueError(f"{what}: lx and ly must share one CUDA device")
    if lx.dtype != torch.int32 or ly.dtype != torch.int32 or lx.ndim != 1 or ly.shape != lx.shape:
        raise ValueError(f"{what}: lx and ly must be (N,) int32, got {lx.shape}, {ly.shape}")
    if not (lx.is_contiguous() and ly.is_contiguous()):
        raise ValueError(f"{what}: lx and ly must be contiguous")
    if win_x <= 0 or win_y <= 0:
        raise ValueError(f"{what}: bad window ({win_x}, {win_y})")


def _launch(what: str, function: str, lx: Tensor, ly: Tensor, win_x: int, win_y: int,
            knob: int) -> Tensor:
    _check(what, lx, ly, win_x, win_y)
    library = hist_ab_library()
    out = torch.zeros((1, win_x, win_y), dtype=torch.int32, device=lx.device)
    with torch.cuda.device(lx.device):
        code = getattr(library, function)(
            lx.data_ptr(), ly.data_ptr(), out.data_ptr(), lx.shape[0], win_x, win_y, knob,
            torch.cuda.current_stream(lx.device).cuda_stream,
        )
    check(library, code, what)
    return out


def hist_onehot(lx: Tensor, ly: Tensor, win_x: int, win_y: int, chunk: int = 1024) -> Tensor:
    """Kernel B7, ``onehot``: the counts as the one-hot contraction on the
    int8 tensor cores, ``chunk`` particles staged per step.  A CUDA tensor
    launches the kernel (or raises); a CPU tensor takes the plain version.
    ``hist_onehot.launches`` counts kernel launches."""
    if lx.device.type == "cpu":
        return hist_ab_reference(lx, ly, win_x, win_y)
    if chunk not in ONEHOT_CHUNKS:
        raise ValueError(f"hist_onehot: chunk must be one of {ONEHOT_CHUNKS}, got {chunk}")
    out = _launch("hist_onehot", "lynx_hist_onehot", lx, ly, win_x, win_y, chunk)
    hist_onehot.launches += 1
    return out


hist_onehot.launches = 0


def hist_twolevel(lx: Tensor, ly: Tensor, win_x: int, win_y: int,
                  band_rows: int = BAND_ROWS) -> Tensor:
    """Kernel B7, ``twolevel``: the counts with the window in bands of
    ``band_rows`` rows in shared memory.  A CUDA tensor launches the kernel
    (or raises); a CPU tensor takes the plain version.
    ``hist_twolevel.launches`` counts kernel launches."""
    if lx.device.type == "cpu":
        return hist_ab_reference(lx, ly, win_x, win_y)
    out = _launch("hist_twolevel", "lynx_hist_twolevel", lx, ly, win_x, win_y, band_rows)
    hist_twolevel.launches += 1
    return out


hist_twolevel.launches = 0

#: The A/B's variants: name -> (wrapper, its knob).
VARIANTS = {
    **{f"onehot_c{chunk}": (hist_onehot, dict(chunk=chunk)) for chunk in ONEHOT_CHUNKS},
    **{f"twolevel_b{rows}": (hist_twolevel, dict(band_rows=rows)) for rows in (28, 56, 112)},
}
DEFAULT_VARIANTS = "onehot_c256,onehot_c1024,onehot_c2048,twolevel_b28,twolevel_b56,twolevel_b112"


def workload(particles: int, win: Tuple[int, int], seed: int = 0,
             device="cuda") -> Tuple[Tensor, Tensor]:
    """The flagship read's indices: a Gaussian spot (sigma win / 8 about the
    window's centre) clipped into the window, ``(N,)`` int32 each."""
    win_x, win_y = win
    generator = torch.Generator(device=device).manual_seed(seed)
    shape = (particles,)
    x = torch.randn(shape, generator=generator, device=device) * (win_x / 8) + win_x / 2
    y = torch.randn(shape, generator=generator, device=device) * (win_y / 8) + win_y / 2
    lx = x.clamp(0, win_x - 1).to(torch.int32)
    ly = y.clamp(0, win_y - 1).to(torch.int32)
    return lx, ly


def run_variant(name: str, lx: Tensor, ly: Tensor, win_x: int, win_y: int,
                iters: int = 200) -> Tuple[float, float]:
    """Check a variant exactly against the plain version, then time it:
    ``(ms per read by CUDA events, device ms of its kernel)``."""
    wrapper, knob = VARIANTS[name]
    counts = wrapper(lx, ly, win_x, win_y, **knob)
    if not torch.equal(counts, hist_ab_reference(lx, ly, win_x, win_y)):
        raise AssertionError(f"hist_ab: {name} does not match the plain version")
    kernel = "onehot_kernel" if wrapper is hist_onehot else "twolevel_kernel"

    def read():
        return wrapper(lx, ly, win_x, win_y, **knob)

    return cuda_ms(read, iters), device_ms(read, 20, kernel)[1]


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Run the A/B on the card and print one JSON line per variant and per
    yardstick; return the records."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--particles", type=int, default=100_000)
    parser.add_argument("--win", default="952,256")
    parser.add_argument("--variants", default=DEFAULT_VARIANTS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hist_ab: this A/B needs a CUDA device")
    win_x, win_y = (int(v) for v in args.win.split(","))
    lx, ly = workload(args.particles, (win_x, win_y))

    records = []
    for name in args.variants.split(","):
        ms, device = run_variant(name, lx, ly, win_x, win_y)
        records.append({"variant": name, "ms_per_read": ms, "win": [win_x, win_y],
                        "particles": args.particles, "device_ms": device})
        print(json.dumps(records[-1]), flush=True)

    # Yardsticks on the same indices: B1's count mode (one batch row), and
    # one torch.bincount of the in-window pairs' flat indices.
    from lynx_tpu_torch.ops.histogram import window_histogram

    inside = (lx >= 0) & (lx < win_x) & (ly >= 0) & (ly < win_y)
    flat = lx[inside].long() * win_y + ly[inside].long()
    yardsticks = {
        "B1 window_histogram": (lambda: window_histogram(lx[None], ly[None], None, win_x, win_y),
                                "window_histogram_kernel"),
        "torch.bincount": (lambda: torch.bincount(flat, minlength=win_x * win_y), None),
    }
    for name, (fn, kernel) in yardsticks.items():
        total, own = device_ms(fn, 20, kernel or "")
        records.append({"variant": name, "ms_per_read": cuda_ms(fn, 200),
                        "win": [win_x, win_y], "particles": args.particles,
                        "device_ms": own if kernel else total})
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
