"""Plotting, JAX package against the PyTorch port, with the Agg backend.

On ``tests/test_plotting.py``'s segment, on a segment of the two types it
leaves out (RBend, CustomTransferMap) and on the ARES EA, all in float64, each plotting method draws the same artists:
patches with equal position, width, height, colour and alpha, and lines
with equal data to 1e-12 of the largest value.  The reference particle
traces are drawn from a given beam; both packages linspace the reference
particles in float32 and track them in float32, so the traces are held to
1e-5 of the largest value (float32 rounding over ~30 pieces).
"""

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lynx_tpu as lt  # noqa: E402
import lynx_tpu_torch as ltt  # noqa: E402
from lynx_tpu.models import ares_ea_segment as jax_ares_ea_segment  # noqa: E402
from lynx_tpu_torch.models import ares_ea_segment  # noqa: E402

RTOL = 1e-12
TRACE_RTOL = 1e-5


def build(package, tensor):
    """``tests/test_plotting.py``'s segment in one package."""
    cpu = {} if package is lt else {"device": "cpu"}
    a = lambda v: tensor([v])  # noqa: E731
    return package.Segment(
        [
            package.Drift(length=a(0.5), name="d1"),
            package.Quadrupole(length=a(0.2), k1=a(4.2), name="q1"),
            package.Dipole(length=a(0.3), angle=a(0.1), name="b1"),
            package.HorizontalCorrector(length=a(0.1), angle=a(1e-4), name="h1"),
            package.Cavity(length=a(0.5), name="c1"),
            package.BPM(name="bpm1", **cpu),
            package.Screen(name="s1", **cpu),
            package.Solenoid(length=a(0.2), name="sol1"),
            package.Undulator(length=a(0.3), name="u1"),
            package.VerticalCorrector(length=a(0.1), angle=a(1e-4), name="v1"),
            package.Aperture(name="a1", **cpu),
            package.Marker(name="m1", **cpu),
        ],
        name="plotme",
    )


def build_more(package, tensor):
    """The types ``tests/test_plotting.py``'s segment leaves out: RBend (a
    Dipole's patch) and CustomTransferMap (none), with a negative angle."""
    cpu = {} if package is lt else {"device": "cpu"}
    dtype = {"dtype": jnp.float64} if package is lt else {"dtype": torch.float64, **cpu}
    tm = np.eye(7)
    tm[0, 1] = tm[2, 3] = 0.4
    return package.Segment(
        [
            package.RBend(length=tensor([0.4]), angle=tensor([-0.05]), name="r1"),
            package.CustomTransferMap(tm[None], length=tensor([0.4]), name="t1", **dtype),
            package.Drift(length=tensor([0.3]), name="d2"),
        ],
        name="more",
    )


def segments(which):
    if which == "more_types":
        return (build_more(lt, lambda v: jnp.asarray(v, jnp.float64)),
                build_more(ltt, lambda v: torch.tensor(v, dtype=torch.float64)))
    if which == "every_type":
        return (build(lt, lambda v: jnp.asarray(v, jnp.float64)),
                build(ltt, lambda v: torch.tensor(v, dtype=torch.float64)))
    jax_segment = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), jax_ares_ea_segment())
    return jax_segment, ares_ea_segment(dtype=torch.float64, device="cpu")


def beams():
    twiss = dict(beta_x=[5.0], alpha_x=[0.3], emittance_x=[3.5e-9], beta_y=[4.0],
                 alpha_y=[-0.2], emittance_y=[2.5e-9], energy=[1e8])
    return (
        lt.ParameterBeam.from_twiss(**{k: jnp.asarray(v, jnp.float64) for k, v in twiss.items()},
                                    dtype=jnp.float64),
        ltt.ParameterBeam.from_twiss(**{k: torch.tensor(v, dtype=torch.float64)
                                        for k, v in twiss.items()},
                                     dtype=torch.float64, device="cpu"),
    )


def artists(fig):
    """Every axes' patches and lines, as comparable values."""
    out = []
    for ax in fig.axes:
        patches = [(tuple(map(float, p.get_xy())), float(p.get_width()), float(p.get_height()),
                    p.get_facecolor(), p.get_alpha(), p.get_zorder()) for p in ax.patches]
        lines = [(np.asarray(line.get_xdata(), float), np.asarray(line.get_ydata(), float),
                  line.get_color(), line.get_linestyle(), line.get_label()) for line in ax.lines]
        out.append((patches, lines, ax.get_xlabel(), ax.get_ylabel(), ax.get_title()))
    return out


def assert_same_artists(got, want, line_rtol):
    assert len(got) == len(want)
    for (g_patches, g_lines, *g_text), (w_patches, w_lines, *w_text) in zip(got, want):
        assert g_text == w_text
        assert len(g_patches) == len(w_patches)
        for g, w in zip(g_patches, w_patches):
            np.testing.assert_allclose(g[0] + g[1:3], w[0] + w[1:3], rtol=RTOL, atol=RTOL)
            assert g[3:] == w[3:]
        assert len(g_lines) == len(w_lines)
        for (gx, gy, *g_style), (wx, wy, *w_style) in zip(g_lines, w_lines):
            assert g_style == w_style
            for g_data, w_data in ((gx, wx), (gy, wy)):
                scale = max(float(np.abs(w_data).max()), 1e-300)
                np.testing.assert_allclose(g_data, w_data, rtol=line_rtol, atol=line_rtol * scale)


def draw(method, segment, beam):
    fig = plt.figure()
    if method == "plot":
        segment.plot(fig.add_subplot(111), 0)
    elif method == "plot_reference_particle_traces":
        axx, axy = fig.subplots(2)
        segment.plot_reference_particle_traces(axx, axy, beam, num_particles=5, resolution=0.1)
    elif method == "plot_overview":
        segment.plot_overview(fig=fig, beam=beam, n=3, resolution=0.1)
    elif method == "plot_twiss":
        segment.plot_twiss(beam, ax=fig.add_subplot(111))
    else:
        plt.close(fig)
        segment.plot_twiss_over_lattice(beam)
        fig = plt.gcf()
    out = artists(fig)
    plt.close("all")
    return out


@pytest.mark.parametrize("which", ["every_type", "more_types", "ares_ea"])
@pytest.mark.parametrize("method", ["plot", "plot_reference_particle_traces", "plot_overview",
                                    "plot_twiss", "plot_twiss_over_lattice"])
def test_plots_match_jax(which, method):
    jax_segment, torch_segment = segments(which)
    jax_beam, torch_beam = beams()
    want = draw(method, jax_segment, jax_beam)
    got = draw(method, torch_segment, torch_beam)
    assert any(patches or lines for patches, lines, *_ in want)
    traces = method in ("plot_reference_particle_traces", "plot_overview")
    assert_same_artists(got, want, TRACE_RTOL if traces else RTOL)


def test_reference_traces_without_a_beam():
    """Without a beam the port draws the default linspaced particles on the
    segment's device."""
    _, segment = segments("every_type")
    fig, (axx, axy) = plt.subplots(2)
    segment.plot_reference_particle_traces(axx, axy, num_particles=4, resolution=0.1)
    assert len(axx.lines) == len(axy.lines) == 4
    assert all(np.isfinite(line.get_ydata()).all() for line in axx.lines + axy.lines)
    plt.close("all")

