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
``particles``, ``device_ms`` (every kernel the read launches, the output's
zeroing included) and ``kernel_ms`` (the variant's main kernel alone: the
contraction, the cluster kernel, B1's kernel; null for ``torch.bincount``).

Variants: ``onehot_c<chunk>`` (the one-hot contraction on the int8 tensor
cores over the particles bucketed by 16-row tile, a warp contracting at
most ``chunk`` particles of one bucket) and ``twolevel_c<C>k<K>`` (the
whole window in the distributed shared memory of a thread-block cluster of
C blocks, K clusters splitting the pairs).  The TPU variants'
``compare_dtype`` and ``pretrans`` exist for the TPU's vector lanes and
matrix-unit layout and have no counterpart here.
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

#: C signatures of B7's entry points: the counts (lx, ly, out, [workspace,]
#: n, win_x, win_y, chunk or cluster size and clusters, stream); the onehot
#: read's int32 workspace (n, win_x, chunk) and its contraction's warps (n,
#: win_x, win_y, chunk); the clusters of a size the card holds at once for a
#: window (win_x, win_y, cluster size).
_B7_SIGNATURE = {
    "lynx_hist_onehot": (
        ctypes.c_int,
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ),
    "lynx_hist_twolevel": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
    "lynx_hist_onehot_workspace": (
        ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int],
    ),
    "lynx_hist_onehot_warps": (
        ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    ),
    "lynx_hist_twolevel_max_clusters": (ctypes.c_int, [ctypes.c_int] * 3),
}

#: The onehot knob: the most particles of one bucket (16-row tile) that a
#: warp contracts; the tile's other spans go to other warps.  256 is the
#: fastest of the three on an H100 (PERF.md).
ONEHOT_CHUNKS = (256, 1024, 2048)
#: The twolevel knobs: blocks of a cluster (8 portable, 16 non-portable:
#: 122 KB and 61 KB of the flagship window a block) and clusters splitting
#: the pairs.  The default is the fastest of the A/B on an H100 (PERF.md).
TWOLEVEL_CLUSTERS = (8, 16)
TWOLEVEL_SPLITS = (1, 2, 4, 8)
CLUSTER, SPLITS = 16, 4


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
            knobs: Tuple[int, ...], out: Tensor, *workspace: Tensor) -> Tensor:
    library = hist_ab_library()
    with torch.cuda.device(lx.device):
        code = getattr(library, function)(
            lx.data_ptr(), ly.data_ptr(), out.data_ptr(), *(w.data_ptr() for w in workspace),
            lx.shape[0], win_x, win_y, *knobs, torch.cuda.current_stream(lx.device).cuda_stream,
        )
    check(library, code, what)
    return out


def hist_onehot(lx: Tensor, ly: Tensor, win_x: int, win_y: int, chunk: int = 256) -> Tensor:
    """Kernel B7, ``onehot``: the counts as the one-hot contraction on the
    int8 tensor cores over the pairs bucketed by 16-row tile, a warp taking
    at most ``chunk`` particles of a bucket (a multiple of 32).  Three
    kernels (count, scatter, contraction); the first zeroes the output.  A
    CUDA tensor launches them (or raises); a CPU tensor takes the plain
    version.  ``hist_onehot.launches`` counts reads launched."""
    if lx.device.type == "cpu":
        return hist_ab_reference(lx, ly, win_x, win_y)
    if chunk % 32 or not 32 <= chunk <= 65536:
        raise ValueError(f"hist_onehot: chunk must be a multiple of 32 up to 65536, got {chunk}")
    _check("hist_onehot", lx, ly, win_x, win_y)
    library = hist_ab_library()
    out = torch.empty((1, win_x, win_y), dtype=torch.int32, device=lx.device)
    workspace = torch.empty((library.lynx_hist_onehot_workspace(lx.shape[0], win_x, chunk),),
                            dtype=torch.int32, device=lx.device)
    _launch("hist_onehot", "lynx_hist_onehot", lx, ly, win_x, win_y, (chunk,), out, workspace)
    hist_onehot.launches += 1
    return out


hist_onehot.launches = 0


def hist_twolevel(lx: Tensor, ly: Tensor, win_x: int, win_y: int, cluster: int = CLUSTER,
                  splits: int = SPLITS) -> Tensor:
    """Kernel B7, ``twolevel``: the counts with the whole window in the
    distributed shared memory of a thread-block cluster of ``cluster``
    blocks (1-16), ``splits`` clusters splitting the pairs (the output then
    zeroed first, in the same entry point).  A CUDA tensor launches the
    kernel or raises, also where the card can hold no cluster of that size
    (no smaller cluster is taken); a CPU tensor takes the plain version.
    ``hist_twolevel.launches`` counts kernel launches."""
    if lx.device.type == "cpu":
        return hist_ab_reference(lx, ly, win_x, win_y)
    _check("hist_twolevel", lx, ly, win_x, win_y)
    out = torch.empty((1, win_x, win_y), dtype=torch.int32, device=lx.device)
    _launch("hist_twolevel", "lynx_hist_twolevel", lx, ly, win_x, win_y, (cluster, splits), out)
    hist_twolevel.launches += 1
    return out


hist_twolevel.launches = 0


def twolevel_max_clusters(win_x: int, win_y: int, cluster: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the twolevel kernel's clusters
    of ``cluster`` blocks for a (win_x, win_y) window; raises where the
    query fails (a window whose rows pass a block's shared memory)."""
    library = hist_ab_library()
    clusters = library.lynx_hist_twolevel_max_clusters(win_x, win_y, cluster)
    if clusters < 0:
        check(library, -clusters, "hist_twolevel_max_clusters")
    return clusters

#: The A/B's variants: name -> (wrapper, its knob).
#: Each variant's main kernel, timed apart from the rest of its read.
KERNELS = {"hist_onehot": "onehot_contract_kernel", "hist_twolevel": "twolevel_kernel"}
VARIANTS = {
    **{f"onehot_c{chunk}": (hist_onehot, dict(chunk=chunk)) for chunk in ONEHOT_CHUNKS},
    **{f"twolevel_c{c}k{k}": (hist_twolevel, dict(cluster=c, splits=k))
       for c in TWOLEVEL_CLUSTERS for k in TWOLEVEL_SPLITS},
}
DEFAULT_VARIANTS = ",".join(VARIANTS)


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
                iters: int = 200) -> Tuple[float, float, float]:
    """Check a variant exactly against the plain version, then time it:
    ``(ms per read by CUDA events, device ms of every kernel of the read,
    device ms of its main kernel)``."""
    wrapper, knob = VARIANTS[name]
    counts = wrapper(lx, ly, win_x, win_y, **knob)
    if not torch.equal(counts, hist_ab_reference(lx, ly, win_x, win_y)):
        raise AssertionError(f"hist_ab: {name} does not match the plain version")

    def read():
        return wrapper(lx, ly, win_x, win_y, **knob)

    return (cuda_ms(read, iters), *device_ms(read, 20, KERNELS[wrapper.__name__]))


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
        ms, device, kernel = run_variant(name, lx, ly, win_x, win_y)
        records.append({"variant": name, "ms_per_read": ms, "win": [win_x, win_y],
                        "particles": args.particles, "device_ms": device, "kernel_ms": kernel})
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
                        "device_ms": total, "kernel_ms": own if kernel else None})
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
