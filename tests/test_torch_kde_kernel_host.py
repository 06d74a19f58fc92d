"""Kernel B9 (``csrc/kde.cu``, GPSR's KDE image and its gradient) and its
wrapper in ``ops/kde.py``, on the CPU.

B9's source is compiled as host C++ against the stand-in ``cuda_runtime.h``
of ``test_torch_kernels_host.py`` (blocks one after another, a block's
threads as ``std::thread``s, ``__syncthreads`` a barrier), and its entry
points are driven through the wrapper's own argument marshalling
(``_image_call``, ``_grad_call``) on CPU tensors, against the plain version
``kde_sums_reference`` and its autograd gradient: float64 within 1e-12 of
the largest pixel or gradient, float within ``KDE_RTOL`` (``chip_smoke``'s
G1 bound).  Beside it: the forward's tile and split plan covers every pixel
and every particle once; CPU tensors keep the blocked route; importing the
package builds nothing; the wrapper refuses what B9 does not take, before
the library is loaded."""

import ctypes
import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lynx_tpu_torch import _build
from lynx_tpu_torch.ops import kde

from test_torch_kernels_host import STAND_IN, host_source

ROOT = Path(__file__).resolve().parents[1]
KDE_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(scope="module")
def host_kde(tmp_path_factory):
    compiler = shutil.which("g++")
    assert compiler, "the host build of B9 needs g++"
    root = tmp_path_factory.mktemp("host_kde")
    (root / "cuda_runtime.h").write_text(STAND_IN)
    (root / "kde.cpp").write_text(host_source((_build.CSRC / "kde.cu").read_text()))
    target = root / "libkde.so"
    subprocess.run(
        [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
         f"-I{root}", "-o", str(target), str(root / "kde.cpp")],
        check=True, capture_output=True, text=True,
    )
    library = ctypes.CDLL(str(target))
    signatures = {"lynx_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
                  **kde._B9_SIGNATURE}
    for function, (restype, argtypes) in signatures.items():
        getattr(library, function).restype = restype
        getattr(library, function).argtypes = argtypes
    return library


def operands(settings, n, height, width, dtype, seed=0):
    """Particles around the middle of a screen of ``height`` x ``width``
    pixels (some beyond its edges), weights in [0, 1), the centres and a
    cotangent."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((settings, n), generator=gen, dtype=torch.float64) * 0.4
    y = torch.randn((settings, n), generator=gen, dtype=torch.float64) * 0.3
    weights = torch.rand((settings, n), generator=gen, dtype=torch.float64)
    x_centres = torch.linspace(-1.0, 1.0, width, dtype=torch.float64)
    y_centres = torch.linspace(0.8, -0.8, height, dtype=torch.float64)
    cotangent = torch.randn((settings, height, width), generator=gen, dtype=torch.float64)
    return [t.to(dtype) for t in (x, y, weights, x_centres, y_centres, cotangent)]


def plain(x, y, weights, x_centres, y_centres, bandwidth, cotangent):
    """The plain version's images and gradients in float64."""
    leaves = [t.detach().double().clone().requires_grad_(True)
              for t in (x, y, weights) if t is not None]
    raw = kde.kde_sums_reference(*leaves[:2], leaves[2] if len(leaves) > 2 else None,
                                 x_centres.double(), y_centres.double(), bandwidth)
    grads = torch.autograd.grad(raw, leaves, cotangent.double())
    return raw.detach(), (*grads, None)[:3]


def gap(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def image_and_grads(host_kde, x, y, weights, xc, yc, bandwidth, cotangent, plan, need=(1, 1, 1)):
    raw = kde._image_call(host_kde, x, y, weights, xc, yc, bandwidth, plan, None)
    grads = kde._grad_call(host_kde, x, y, weights, xc, yc, bandwidth, cotangent,
                           *map(bool, need), None)
    return raw, grads


SHAPES = [
    (16, 100_000, 255, 306, 132),  # the GPSR cell
    (1, 100_000, 255, 306, 132),
    (16, 100_003, 255, 306, 132),
    (1, 7, 255, 306, 132),
    (16, 1, 40, 48, 132),
    (3, 1_000, 300, 70, 1),
    (1, 0, 255, 306, 132),
    (1, 1_000_000, 2040, 2448, 132),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("settings,n,height,width,sms", SHAPES)
def test_the_plan_covers_every_pixel_and_particle_once(settings, n, height, width, sms, dtype):
    """Tiles of TILE_ROWS x TILE_COLS cover the image's rows and columns once
    with no empty tile; the splits cover the particles once with no empty
    split, in spans of whole chunks; at the GPSR cell's shape the blocks fill
    the card's resident slots' last wave to FILL."""
    plan = kde.kde_plan(settings, n, height, width, sms, dtype)
    for tiles, size, length in ((plan.row_tiles, kde.TILE_ROWS[dtype], height),
                                (plan.col_tiles, kde.TILE_COLS, width)):
        covered = [0] * length
        for tile in range(tiles):
            cells = range(tile * size, min((tile + 1) * size, length))
            assert len(cells) > 0
            for i in cells:
                covered[i] += 1
        assert covered == [1] * length
    assert plan.span % kde.CHUNK == 0 and plan.splits >= 1
    counts = [0] * n
    for split in range(plan.splits):
        particles = range(split * plan.span, min((split + 1) * plan.span, n))
        assert len(particles) > 0 or n == 0
        for p in particles:
            counts[p] += 1
    assert counts == [1] * n
    blocks = settings * plan.row_tiles * plan.col_tiles * plan.splits
    slots = sms * kde.RESIDENT
    if (settings, n, height, width) == (16, 100_000, 255, 306):
        assert blocks / (-(-blocks // slots) * slots) >= kde.FILL


CASES = [
    # dtype, weighted, settings, n, height, width, splits (None: the plan's)
    (torch.float64, True, 2, 300, 20, 70, None),
    (torch.float64, False, 2, 300, 20, 70, 3),
    (torch.float64, True, 1, 37, 130, 10, 2),
    (torch.float32, True, 1, 37, 260, 10, 2),
    (torch.float32, True, 2, 300, 20, 70, 3),
    (torch.float32, False, 3, 129, 24, 65, None),
]


@pytest.mark.parametrize("dtype,weighted,settings,n,height,width,splits", CASES)
def test_b9_matches_the_plain_version(host_kde, dtype, weighted, settings, n, height, width,
                                      splits):
    """Images and the gradients of x, y and the weights against the plain
    version, on ragged particles (not a whole chunk or tile), images of
    ragged tiles (rows past one tile, columns past one tile), the plan's
    split and forced ones; two calls give equal bits."""
    x, y, weights, xc, yc, cotangent = operands(settings, n, height, width, dtype)
    weights = weights if weighted else None
    h = 0.07
    plan = kde.kde_plan(settings, n, height, width, 132, dtype)
    if splits is not None:
        span = -(-n // (splits * kde.CHUNK)) * kde.CHUNK
        plan = plan._replace(splits=-(-n // span), span=span)
        assert plan.splits == splits
    want, want_grads = plain(x, y, weights, xc, yc, h, cotangent)
    raw, grads = image_and_grads(host_kde, x, y, weights, xc, yc, h, cotangent, plan)
    assert raw.shape == (settings, height, width) and raw.dtype == dtype
    assert gap(raw, want) <= KDE_RTOL[dtype]
    for got, expected in zip(grads, want_grads):
        if expected is None:
            assert got is None
        else:
            assert got.shape == (settings, n) and gap(got, expected) <= KDE_RTOL[dtype]
    again, grads_again = image_and_grads(host_kde, x, y, weights, xc, yc, h, cotangent, plan)
    assert torch.equal(raw, again)
    assert all(a is None or torch.equal(a, b) for a, b in zip(grads, grads_again))


@pytest.mark.parametrize("need", [n for n in itertools.product((0, 1), repeat=3) if any(n)])
def test_b9_makes_only_the_gradients_asked_for(host_kde, need):
    """Each subset of (x, y, weights) gives its gradients alone, the same
    as the full set's."""
    x, y, weights, xc, yc, cotangent = operands(2, 200, 20, 70, torch.float64)
    plan = kde.kde_plan(2, 200, 20, 70, 132, torch.float64)
    _, full = image_and_grads(host_kde, x, y, weights, xc, yc, 0.07, cotangent, plan)
    _, some = image_and_grads(host_kde, x, y, weights, xc, yc, 0.07, cotangent, plan, need)
    for wanted, got, every in zip(need, some, full):
        assert (got is None) == (not wanted)
        if wanted:
            assert torch.equal(got, every)


def test_b9_reads_strided_and_broadcast_particles_and_a_tensor_bandwidth(host_kde):
    """The screen's x and y are strided views of (S, N, 7) particles, and a
    beam shared by the settings has a settings stride of 0: B9 reads them
    in place, as contiguous copies give.  A bandwidth tensor on the
    particles' device is read by the kernels, to the same bits as its
    number."""
    S, N, H, W = 3, 150, 20, 70
    gen = torch.Generator().manual_seed(3)
    particles = torch.randn((S, N, 7), generator=gen, dtype=torch.float64) * 0.3
    shared_y = torch.randn(N, generator=gen, dtype=torch.float64) * 0.3
    survival = torch.rand(N, generator=gen, dtype=torch.float64)
    x = particles[..., 0]
    y, weights = shared_y.expand(S, N), survival.expand(S, N)
    assert x.stride() == (7 * N, 7) and y.stride() == (0, 1)
    _, _, _, xc, yc, cotangent = operands(S, N, H, W, torch.float64)
    want, want_grads = plain(x, y, weights, xc, yc, 0.07, cotangent)
    plan = kde.kde_plan(S, N, H, W, 132, torch.float64)
    strided = image_and_grads(host_kde, x, y, weights, xc, yc, 0.07, cotangent, plan)
    dense = image_and_grads(host_kde, x.contiguous(), y.contiguous(), weights.contiguous(), xc,
                            yc, 0.07, cotangent, plan)
    tensor_h = image_and_grads(host_kde, x, y, weights, xc, yc,
                               torch.tensor(0.07, dtype=torch.float64), cotangent, plan)
    for a, b, c in zip([strided[0], *strided[1]], [dense[0], *dense[1]],
                       [tensor_h[0], *tensor_h[1]]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert gap(strided[0], want) <= 1e-12
    assert all(gap(a, b) <= 1e-12 for a, b in zip(strided[1], want_grads))


def test_the_cpu_takes_the_blocked_route(monkeypatch):
    """CPU tensors take the blocked route: its blocks counted, B9's launches
    unchanged, its library never asked for."""
    def refuse():
        raise AssertionError("B9's library was asked for on the CPU")

    monkeypatch.setattr(kde, "kde_library", refuse)
    x, y, weights, xc, yc, cotangent = operands(2, 300, 20, 70, torch.float64)
    x.requires_grad_(True)
    blocks, launches = kde.kde_sums.blocks, kde.kde_sums.launches
    raw = kde.kde_sums(x, y, weights, xc, yc, 0.07, block=128)
    torch.autograd.grad(raw, x, cotangent)
    assert kde.kde_sums.blocks - blocks == 2 * 3
    assert kde.kde_sums.launches == launches
    assert gap(raw.detach(), kde.kde_sums_reference(x.detach(), y, weights, xc, yc, 0.07)) <= 1e-12


def test_the_library_is_not_built_on_import():
    """Importing the package, the KDE, the screen and the reconstruction
    builds and loads no kernel library."""
    code = ("import lynx_tpu_torch, lynx_tpu_torch.ops.kde, lynx_tpu_torch.reconstruction,"
            " lynx_tpu_torch.accelerator.screen\n"
            "from lynx_tpu_torch import _build\n"
            "assert not _build._LIBRARIES and not _build.BUILD_LOG, (_build._LIBRARIES,"
            " _build.BUILD_LOG)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, capture_output=True,
                   text=True)


def _refused(**changes):
    x, y, weights, xc, yc, _ = operands(2, 50, 20, 30, torch.float32)
    args = dict(x=x, y=y, weights=weights, x_centres=xc, y_centres=yc)
    args.update({k: v(args) for k, v in changes.items()})
    return args


REFUSED = {
    "half": _refused(x=lambda a: a["x"].half(), y=lambda a: a["y"].half(),
                     weights=lambda a: a["weights"].half(),
                     x_centres=lambda a: a["x_centres"].half(),
                     y_centres=lambda a: a["y_centres"].half()),
    "integer": _refused(x=lambda a: a["x"].int()),
    "mixed": _refused(y=lambda a: a["y"].double()),
    "mixed_centres": _refused(x_centres=lambda a: a["x_centres"].double()),
    "ragged_y": _refused(y=lambda a: a["y"][:, :-1]),
    "ragged_weights": _refused(weights=lambda a: a["weights"][:1]),
    "one_axis": _refused(x=lambda a: a["x"][0], y=lambda a: a["y"][0],
                         weights=lambda a: a["weights"][0]),
    "square_centres": _refused(x_centres=lambda a: a["x_centres"][None]),
    "strided_centres": _refused(x_centres=lambda a: torch.stack([a["x_centres"]] * 2, 1)[:, 0]),
    "strided_rows": _refused(y_centres=lambda a: a["y_centres"].repeat(2)[::2]),
    "no_pixels": _refused(y_centres=lambda a: a["y_centres"][:0]),
    "too_many_settings": _refused(x=lambda a: a["x"][:1].expand(40_000, 50),
                                  y=lambda a: a["y"][:1].expand(40_000, 50),
                                  weights=lambda a: a["weights"][:1].expand(40_000, 50)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_b9_refuses_what_it_does_not_take(case):
    with pytest.raises(ValueError, match="kde_sums: "):
        kde._check_operands(**REFUSED[case])


def test_b9_refuses_other_devices_and_cotangents_before_loading(monkeypatch):
    """A tensor that is neither on the CPU nor on a CUDA card is refused
    before B9's library is asked for; so is a cotangent of another shape,
    dtype or layout."""
    def refuse():
        raise AssertionError("B9's library was asked for")

    monkeypatch.setattr(kde, "kde_library", refuse)
    x, y, weights, xc, yc, cotangent = (t.to("meta") for t in operands(2, 50, 20, 30,
                                                                       torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        kde.kde_sums(x, y, weights, xc, yc, 0.1)
    x, y, weights, xc, yc, cotangent = operands(2, 50, 20, 30, torch.float32)
    for bad in (cotangent[:, :-1], cotangent.double(), cotangent.transpose(1, 2).contiguous()
                .transpose(1, 2)):
        with pytest.raises(ValueError, match="cotangent"):
            kde._grad_call(None, x, y, weights, xc, yc, 0.1, bad, True, True, True, None)
