"""The CUDA sources of kernels B2-B6, run on the CPU.

There is no nvcc here, so each ``csrc/*.cu`` is compiled as host C++ by gcc
against a stand-in ``cuda_runtime.h``: ``__device__`` and friends are
dropped and a launch ``kernel<<<blocks, threads, shared, stream>>>(args)``
runs the blocks one after another, each block's threads as ``std::thread``s.
``__syncthreads()`` and ``__syncwarp()`` are a ``std::barrier`` over the
block (so a kernel must reach them in the same order on every thread, as
the kernels here do), a ``__shared__`` array is one per kernel and serves
each block in turn, and ``extern __shared__`` memory is a buffer of the
launch's size.  A device intrinsic goes through a small helper that the
stand-in replaces (``LYNX_HOST_STAND_IN``): B6's ``cp.async`` copies are
plain copies there, done at once, and their commit and wait do nothing, so
that the double-buffered stages still run through the kernel's buffer
indexing and barriers.  That runs the kernels' arithmetic and their cooperation
(tape decoding, builders, dual numbers, shared-memory tiles, the ragged
batch) on the plain versions' inputs.  What it cannot check is the device
itself (FMA contraction, memory, occupancy, registers): ``chip_smoke.py``
does that on the card.

Bounds, float64: B3 and B2 within 1e-12 of their plain versions relative to
each setting's largest entry; B5 and B6 within 1e-12, second moments
relative to each setting's largest, first moments to ``sqrt(W max s2[r,
r])``, weight sums exactly equal (``tests/test_torch_particle_moments.py``); B4 within 1e-12 relative to each cotangent's
largest entry, except d/dk1 at settings where k1 is exactly 0.  There the
reference formula's derivative is rounding-limited (``L cos(kL) -
sin(kL)/k`` cancels at kL ~ 1e-7, after the 1e-12 perturbation), so the
kernel's forward-mode chain rule and autograd's reverse mode agree only to
1e-3 of that entry; both packages share the formula.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lynx_tpu_torch as ltt
from lynx_tpu_torch import _build
from lynx_tpu_torch.accelerator import fused as torch_fused
from lynx_tpu_torch.constants import REST_ENERGY_EV
from lynx_tpu_torch.ops import fused_track
from lynx_tpu_torch.ops import table as tbl

from test_torch_particle_moments import (
    SPECS,
    cloud,
    kernel_entries,
    spec_list,
    sums_errors,
    torch_element,
)

RTOL = 1e-12
K1_ZERO_RTOL = 1e-3

STAND_IN = r"""
#pragma once
#include <math.h>
#include <barrier>
#include <cstddef>
#include <cstring>
#include <cstdint>
#include <new>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static
#define LYNX_HOST_STAND_IN 1
struct HostDim3 { unsigned x, y, z; };
static thread_local HostDim3 threadIdx;
static HostDim3 blockIdx, blockDim, gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline double2 make_double2(double x, double y) { return {x, y}; }
static std::barrier<>* lynx_host_barrier = nullptr;
static unsigned char* lynx_host_shared = nullptr;
inline void __syncthreads() { lynx_host_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { lynx_host_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
constexpr int kHostSharedOptin = 232448;  // an H100's 227 KB
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = kHostSharedOptin;
  return 0;
}
template <typename F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
// cp.async: the copy is done at once, so commit and wait have nothing to do.
template <typename T> inline void lynx_cp_async(T* shared_dst, const T* src) { *shared_dst = *src; }
inline void lynx_cp_async_commit() {}
inline void lynx_cp_async_wait_prior() {}
inline void lynx_cp_async_wait_all() {}
// cvt.rn.bf16x2.f32: each to nearest, ties to even, on the bits (finite
// values), lo in the low half.
inline unsigned lynx_host_bf16(float x) {
  unsigned u;
  std::memcpy(&u, &x, 4);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}
inline unsigned lynx_bf16x2(float lo, float hi) {
  return lynx_host_bf16(lo) | (lynx_host_bf16(hi) << 16);
}
inline float lynx_float_of(unsigned bits) {
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}
// mma.sync m16n8k16 bf16 -> f32: each lane leaves its fragments in its
// warp's slot; after a barrier every lane forms its four outputs from the
// whole tiles (the PTX ISA's fragment layouts), then a second barrier frees
// the slots.
struct LynxHostMma { unsigned a[32][4]; unsigned b[32][2]; };
static LynxHostMma lynx_host_mma[32];
inline float lynx_host_bf16_value(unsigned word, int half) {
  return lynx_float_of(((word >> (16 * half)) & 0xffffu) << 16);
}
inline void lynx_mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  LynxHostMma& slot = lynx_host_mma[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  for (int r = 0; r < 4; ++r) slot.a[lane][r] = a[r];
  for (int r = 0; r < 2; ++r) slot.b[lane][r] = b[r];
  lynx_host_barrier->arrive_and_wait();
  for (int c = 0; c < 4; ++c) {
    const int row = lane / 4 + 8 * (c / 2);
    const int col = 2 * (lane % 4) + c % 2;
    float acc = d[c];
    for (int k = 0; k < 16; ++k) {
      const float x = lynx_host_bf16_value(slot.a[4 * (row % 8) + (k % 8) / 2][row / 8 + 2 * (k / 8)], k % 2);
      const float y = lynx_host_bf16_value(slot.b[4 * col + (k % 8) / 2][k / 8], k % 2);
      acc += x * y;
    }
    d[c] = acc;
  }
  lynx_host_barrier->arrive_and_wait();
}
template <typename F>
void lynx_host_launch(F body, unsigned blocks, unsigned threads, size_t shared = 0,
                      cudaStream_t = nullptr) {
  void* memory = ::operator new(shared + 16, std::align_val_t(16));
  lynx_host_shared = static_cast<unsigned char*>(memory);
  gridDim = {blocks, 1, 1};
  blockDim = {threads, 1, 1};
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx = {b, 0, 0};
    std::barrier<> barrier(threads);
    lynx_host_barrier = &barrier;
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t) {
      pool.emplace_back([&body, t] { threadIdx = {t, 0, 0}; body(); });
    }
    for (auto& thread : pool) thread.join();
  }
  ::operator delete(memory, std::align_val_t(16));
}
"""

SIGNATURES = {
    "moment_sweep": fused_track._B3_SIGNATURE,
    "moment_sweep_bwd": fused_track._B4_SIGNATURE,
    "particle_apply": fused_track._B2_SIGNATURE,
    "particle_moment_sweep": fused_track._B5_SIGNATURE,
    "packed_gram": fused_track._B6_SIGNATURE,
}
# kernel<T, ...><<<grid>>>(args); -> lynx_host_launch([&] { kernel<T, ...>(args); }, grid);
LAUNCH = re.compile(r"(\w+<[^<>;]*>)<<<(.*?)>>>\((.*?)\);", flags=re.S)
# extern __shared__ __align__(16) unsigned char name[]; -> a pointer to the launch's buffer.
DYNAMIC_SHARED = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w[\w ]*?)\s+(\w+)\[\];"
)


def host_source(text):
    """A ``.cu`` or ``.cuh`` source as host C++ for the stand-in."""
    text = LAUNCH.sub(r"lynx_host_launch([&] { \1(\3); }, \2);", text)
    return DYNAMIC_SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(lynx_host_shared);", text)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    compiler = shutil.which("g++")
    assert compiler, "the host build of the kernels needs g++"
    root = tmp_path_factory.mktemp("host_kernels")
    (root / "cuda_runtime.h").write_text(STAND_IN)
    for header in _build.CSRC.glob("*.cuh"):
        (root / header.name).write_text(host_source(header.read_text()))
    libraries = {}
    for name, signature in SIGNATURES.items():
        source = host_source((_build.CSRC / f"{name}.cu").read_text())
        (root / f"{name}.cpp").write_text(source)
        target = root / f"lib{name}.so"
        subprocess.run(
            [compiler, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
             f"-I{root}", "-o", str(target), str(root / f"{name}.cpp")],
            check=True, capture_output=True, text=True,
        )
        library = ctypes.CDLL(str(target))
        for function, (restype, argtypes) in signature.items():
            getattr(library, function).restype = restype
            getattr(library, function).argtypes = argtypes
        libraries[name] = library
    return libraries


def run_and_inputs(B, dtype, seed=0):
    """A plan over every ported element type (dynamic and hoisted, tilt and
    misalignment non-zero, k1 = 0 on two settings) and random moments."""
    rng = np.random.default_rng(seed)
    k1 = np.linspace(-5.0, 5.0, B)
    k1[B // 3] = 0.0

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    elements = [
        ltt.Marker(dtype=dtype, device="cpu"),
        ltt.Drift(t([0.5]), dtype=dtype),
        ltt.Quadrupole(t(np.full(B, 0.23)), k1=t(k1), tilt=t(rng.uniform(-0.2, 0.2, B)),
                       misalignment=t(rng.uniform(-2e-4, 2e-4, (B, 2))), dtype=dtype),
        ltt.Drift(t([0.3]), dtype=dtype),
        ltt.HorizontalCorrector(t(np.full(B, 0.1)), angle=t(rng.uniform(-1e-3, 1e-3, B)),
                                dtype=dtype),
        ltt.VerticalCorrector(t(np.full(B, 0.1)), angle=t(rng.uniform(-1e-3, 1e-3, B)),
                              dtype=dtype),
        ltt.Quadrupole(t([0.2]), k1=t([3.0]), tilt=t([0.05]), dtype=dtype),
        ltt.Drift(t(rng.uniform(0.1, 0.6, B)), dtype=dtype),
        ltt.Screen(dtype=dtype, device="cpu"),
    ]
    builders = [torch_fused.element_map_builder(el) for el in elements]
    energy = torch.full((B,), 1.073e8, dtype=dtype)
    mu = t(np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1))
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    cov = t(a @ np.swapaxes(a, 1, 2))
    return builders, energy, mu, cov, torch.from_numpy(k1 == 0.0)


def per_setting_error(actual, expected):
    B = expected.shape[0]
    diff = (actual - expected).abs().reshape(B, -1).amax(dim=1)
    return float((diff / expected.abs().reshape(B, -1).amax(dim=1)).max())


def sweep_plan(B, energy_batched, repeat=1):
    """The plan of :func:`run_and_inputs`'s run (its elements ``repeat``
    times over) as B3 and B4 take it: ``(entries, values, tape, params,
    consts, energy, mu, cov, k1_zero)``, float64."""
    builders, energy, mu, cov, k1_zero = run_and_inputs(B, torch.float64)
    builders = builders * repeat
    if energy_batched:  # every element dynamic, markers and screens included
        energy = energy * torch.linspace(0.9, 1.1, B, dtype=torch.float64)
        plan = torch_fused.plan_run(builders, energy, lambda x: torch.broadcast_to(x, (B,)))
        assert all(entry[0] == "dyn" for entry in plan)
    else:
        plan = torch_fused.plan_run(builders, energy[:1], lambda x: torch.broadcast_to(x, (B,)))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v for _, _, vs in plan for v in vs]
    tape = fused_track._tape(entries, torch.device("cpu"))
    params, consts = fused_track._tape_operands(entries, values, tape, torch.float64, B)
    return entries, values, tape, params, consts, energy, mu, cov, k1_zero


def check_backward(host_kernels, B, entries, values, tape, params, consts, energy, mu, cov,
                   k1_zero):
    """B4 against autograd of the plain sweep, at the module's bounds."""
    rng = np.random.default_rng(1)
    dmu = torch.from_numpy(rng.normal(size=(B, 7)))
    dcov = torch.from_numpy(rng.normal(size=(B, 7, 7)))
    outputs = {
        "d_params": torch.empty((tape.n_params, B), dtype=torch.float64),
        "d_consts": torch.empty((tape.cell_pos.shape[0], B), dtype=torch.float64),
        "d_energy": torch.empty_like(energy),
        "d_mu": torch.empty_like(mu),
        "d_cov": torch.empty_like(cov),
    }
    code = host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd(
        1, tape.rows.data_ptr(), tape.rows.shape[0], tape.cell_pos.data_ptr(), params.data_ptr(),
        consts.data_ptr(), energy.data_ptr(), mu.data_ptr(), cov.data_ptr(), dmu.data_ptr(),
        dcov.data_ptr(), *(t.data_ptr() for t in outputs.values()), B, REST_ENERGY_EV, None,
    )
    assert code == 0
    ref_values, ref_energy, ref_mu, ref_cov = fused_track._reference_sweep_vjp(
        entries, values, energy, mu, cov, dmu, dcov
    )
    rows, sums = iter(outputs["d_params"]), iter(outputs["d_consts"].sum(dim=1))
    offset = 0
    for kind, meta, count in entries:
        for k in range(count):
            got = next(rows) if kind == "dyn" else next(sums)
            want = ref_values[offset + k].reshape(got.shape)
            scale = float(want.abs().max())
            error = (got - want).abs()
            if meta is torch_fused._build_quadrupole and k == 1 and want.dim():
                # d/dk1 at k1 == 0 is rounding-limited (module docstring).
                zero = k1_zero if want.shape[0] == B else torch.zeros_like(k1_zero)
                assert bool((error[zero] <= K1_ZERO_RTOL * want[zero].abs()).all())
                error = error[~zero]
            assert float(error.max()) <= RTOL * scale, (kind, offset + k)
        offset += count
    for name, want in (("d_energy", ref_energy), ("d_mu", ref_mu), ("d_cov", ref_cov)):
        got = outputs[name]
        assert float((got - want).abs().max()) <= RTOL * float(want.abs().max()), name


@pytest.mark.parametrize("energy_batched", [False, True])
def test_moment_sweep_and_backward_match_plain(host_kernels, energy_batched):
    B = 37  # ragged: neither a multiple of B3's 128-thread block nor of B4's tile
    plan = sweep_plan(B, energy_batched)
    entries, values, tape, params, consts, energy, mu, cov, _ = plan
    assert B % host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd_tile(1, len(entries))

    out_mu, out_cov = torch.empty_like(mu), torch.empty_like(cov)
    code = host_kernels["moment_sweep"].lynx_moment_sweep(
        1, tape.rows.data_ptr(), tape.rows.shape[0], params.data_ptr(), consts.data_ptr(),
        energy.data_ptr(), mu.data_ptr(), cov.data_ptr(), out_mu.data_ptr(), out_cov.data_ptr(),
        B, REST_ENERGY_EV, None,
    )
    assert code == 0
    ref_mu, ref_cov = fused_track._table_reference_sweep(entries, values, energy, mu, cov)
    assert per_setting_error(out_mu, ref_mu) <= RTOL
    assert per_setting_error(out_cov, ref_cov) <= RTOL
    check_backward(host_kernels, B, *plan)


def run_sweep(host_kernels, entries, values, energy, mu, cov):
    """B3 on the host: ``(out_mu, out_cov)`` of a plan, float64."""
    B = mu.shape[0]
    tape = fused_track._tape(entries, torch.device("cpu"))
    params, consts = fused_track._tape_operands(entries, values, tape, torch.float64, B)
    out_mu, out_cov = torch.empty_like(mu), torch.empty_like(cov)
    code = host_kernels["moment_sweep"].lynx_moment_sweep(
        1, tape.rows.data_ptr(), tape.rows.shape[0], params.data_ptr(), consts.data_ptr(),
        energy.data_ptr(), mu.data_ptr(), cov.data_ptr(), out_mu.data_ptr(), out_cov.data_ptr(),
        B, REST_ENERGY_EV, None,
    )
    assert code == 0
    return out_mu, out_cov


def support_plan(B, static):
    """A run whose const groups take each support class: drifts (class 1),
    a static corrector between drifts (class 2), a static tilted,
    misaligned quadrupole (dense); between them a quadrupole with
    per-setting k1, tilt and misalignment.  ``static`` makes every element
    batch-invariant: one dense const entry."""
    rng = np.random.default_rng(7)
    n = 1 if static else B
    f64 = dict(dtype=torch.float64)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    elements = [
        ltt.Drift(t([0.4]), **f64),
        ltt.Drift(t([0.2]), **f64),
        ltt.Quadrupole(t(np.full(n, 0.2)), k1=t(rng.uniform(-4, 4, n)),
                       tilt=t(rng.uniform(-0.3, 0.3, n)),
                       misalignment=t(rng.uniform(-3e-4, 3e-4, (n, 2))), **f64),
        ltt.Drift(t([0.3]), **f64),
        ltt.HorizontalCorrector(t([0.1]), angle=t([5e-4]), **f64),
        ltt.Drift(t([0.25]), **f64),
        ltt.Quadrupole(t(np.full(n, 0.2)), k1=t(rng.uniform(-4, 4, n)), **f64),
        ltt.Quadrupole(t([0.15]), k1=t([2.5]), tilt=t([0.1]), misalignment=t([[1e-4, -2e-4]]),
                       **f64),
        ltt.Drift(t([0.5]), **f64),
    ]
    builders = [torch_fused.element_map_builder(el) for el in elements]
    energy = torch.full((B,), 1.073e8, **f64)
    plan = torch_fused.plan_run(builders, energy[:1], lambda x: torch.broadcast_to(x, (B,)))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v for _, _, vs in plan for v in vs]
    mu = t(np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1))
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    return entries, values, energy, mu, t(a @ np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("B, static", [(2, False), (70, False), (1, True), (65, True)])
def test_moment_sweep_on_const_support_classes(host_kernels, B, static):
    """B3's chain runs each const entry over its support class; every class,
    and a plan of const entries only, against the plain version (ragged B
    across the 64-setting block)."""
    entries, values, energy, mu, cov = support_plan(B, static)
    tape = fused_track._tape(entries, torch.device("cpu"))
    kinds = [(row[0], row[4]) for row in tape.rows.tolist()]
    const = fused_track.TAPE_CONST
    if static:
        assert kinds == [(const, 0)]
    else:
        assert kinds == [(const, 1), (fused_track.TAPE_QUAD, 0), (const, 2),
                         (fused_track.TAPE_QUAD, 0), (const, 0)]
    out_mu, out_cov = run_sweep(host_kernels, entries, values, energy, mu, cov)
    ref_mu, ref_cov = fused_track._table_reference_sweep(entries, values, energy, mu, cov)
    assert per_setting_error(out_mu, ref_mu) <= RTOL
    assert per_setting_error(out_cov, ref_cov) <= RTOL


def test_const_support_classes():
    """A layout takes the smallest class that holds its non-zero cells, and
    only with literal ones on its diagonal."""
    identity = [[1.0 if i == j else 0.0 for j in range(7)] for i in range(7)]

    def layout(cells):
        out = [row[:] for row in identity]
        for (i, j), value in cells.items():
            out[i][j] = value
        return out

    support = fused_track._const_support
    assert support(identity) == 1
    assert support(layout({(0, 1): 0, (2, 3): 0.3, (4, 5): 1})) == 1
    assert support(layout({(0, 1): 0, (1, 6): 1, (4, 6): 2})) == 2
    assert support(layout({(1, 0): 0})) == 0  # a focusing cell
    assert support(layout({(5, 6): 0})) == 0  # column 6 below row 4
    assert support(layout({(3, 3): 0})) == 0  # a diagonal cell that is not a literal 1
    assert support(layout({(2, 2): 0.5})) == 0


def test_backward_tile_follows_the_tape_and_the_dtype(host_kernels):
    """B4 keeps each setting's prefix products in shared memory: the
    settings per block (at most 32, whole warps from 4 on) shrink as the
    tape grows and in float64, and are 0 where one setting cannot fit in
    the 227 KB of an H100 block."""
    tile = host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd_tile
    assert tile(0, 11) == tile(1, 11) == 32  # path T's plan: 3.4 / 6.8 KB a setting
    assert tile(0, 36) == 24 and tile(1, 36) == 12 and tile(1, 60) == 8
    assert tile(1, 200) == 2 and tile(0, 700) == 1
    assert tile(1, 700) == 0
    # Such a launch returns the code that the wrapper raises on, before it
    # reads any operand.
    launch = host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd
    assert launch(1, None, 700, *[None] * 13, 1, REST_ENERGY_EV, None) == (
        fused_track._B4_DOES_NOT_FIT
    )


@pytest.mark.parametrize("B, repeat, tile", [(5, 4, 12), (37, 4, 12), (5, 25, 2)])
def test_backward_on_a_tape_that_shrinks_the_tile(host_kernels, B, repeat, tile):
    """The run ``repeat`` times over, every entry dynamic: 36 entries give 12
    settings a block in float64, so B = 37 fills three blocks and one setting
    of a fourth and B = 5 one block in part; 225 entries give 2 settings a
    block, a block of 16 threads that fills half a warp."""
    plan = sweep_plan(B, energy_batched=True, repeat=repeat)
    entries = plan[0]
    assert len(entries) == 9 * repeat
    assert host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd_tile(1, len(entries)) == tile
    check_backward(host_kernels, B, *plan)


def push_inputs(B, N, dtype, shift=0):
    """The run's composed maps as B2 takes them (layout, (B, 49) matrix) and
    (B, N, 7) particles; ``shift`` starts the particles that many particles
    into their buffer, off the 16-byte alignment of B2's vector path."""
    builders, energy, _, _, _ = run_and_inputs(B, torch.float64, seed=2)
    total = None
    for params, fn in builders:
        T = fn([torch.broadcast_to(p, (B,)) for p in params], energy)
        total = T if total is None else tbl.compose(T, total)
    layout, _ = fused_track._split_table(total)
    matrix = torch.stack(
        [tbl.broadcast_cell(c, (B,), torch.float64) for row in total for c in row], dim=-1
    ).to(dtype).contiguous()
    rng = np.random.default_rng(3)
    cloud = np.concatenate(
        [rng.normal(scale=1e-4, size=(B * N + shift, 6)), np.ones((B * N + shift, 1))], axis=-1
    )
    particles = torch.from_numpy(cloud).to(dtype).reshape(-1)[7 * shift:].reshape(B, N, 7)
    return layout, matrix, particles


def check_push(host_kernels, layout, matrix, particles, rtol):
    """B2 on the maps and on their transposes (its use in the backward)
    against the plain version."""
    B, N, _ = particles.shape
    for lay, mat in ((layout, matrix),
                     (fused_track._transpose_layout(layout),
                      matrix.reshape(B, 7, 7).transpose(1, 2).reshape(B, 49).contiguous())):
        zeros, ones = fused_track._layout_masks(lay)
        out = torch.empty_like(particles)
        code = host_kernels["particle_apply"].lynx_particle_apply(
            int(particles.dtype == torch.float64), mat.data_ptr(), particles.data_ptr(),
            out.data_ptr(), B, N, zeros, ones, None,
        )
        assert code == 0
        expected = fused_track.particle_apply_reference(lay, mat, particles)
        assert per_setting_error(out, expected) <= rtol


def test_particle_apply_matches_plain(host_kernels):
    check_push(host_kernels, *push_inputs(19, 45, torch.float64), RTOL)


@pytest.mark.parametrize(
    "B, N, dtype, shift",
    [
        (2, 700, torch.float64, 0),  # spans inside one setting, one straddling, a short tail
        (3, 300, torch.float64, 1),  # off 16 bytes: every span value by value
        (4, 1000, torch.float32, 0),  # float: 512-particle spans of float4 vectors
    ],
)
def test_particle_apply_spans(host_kernels, B, N, dtype, shift):
    """B2 moves 14 KB spans of the (B, N, 7) array through shared memory:
    spans that straddle settings, a ragged last span, tensors off the 16-byte
    alignment of its vectors, and float."""
    layout, matrix, particles = push_inputs(B, N, dtype, shift)
    assert (particles.data_ptr() % 16 != 0) == bool(shift)
    check_push(host_kernels, layout, matrix, particles, RTOL if dtype == torch.float64 else 1e-6)


def test_particle_apply_skips_structural_zeros(host_kernels):
    """A structural zero adds nothing, where 0 * x would add a NaN: an
    infinite coordinate in a column that a row does not use leaves that row
    finite, as in the plain version."""
    B, N = 3, 50
    layout, matrix, particles = push_inputs(B, N, torch.float64)
    zeros, ones = fused_track._layout_masks(layout)
    row, column = next((i, j) for j in range(7) for i in range(7) if zeros >> (7 * i + j) & 1)
    particles = particles.clone()
    particles[1, 7, column] = float("inf")
    out = torch.empty_like(particles)
    code = host_kernels["particle_apply"].lynx_particle_apply(
        1, matrix.data_ptr(), particles.data_ptr(), out.data_ptr(), B, N, zeros, ones, None,
    )
    assert code == 0
    expected = fused_track.particle_apply_reference(layout, matrix, particles)
    finite = torch.isfinite(expected)
    assert bool(finite[1, 7, row]) and not bool(finite.all())
    assert torch.equal(torch.isfinite(out), finite)
    assert torch.equal(torch.isnan(out), torch.isnan(expected))
    zero = torch.zeros_like(out)
    kept = (torch.where(finite, out, zero), torch.where(finite, expected, zero))
    assert per_setting_error(*kept) <= RTOL


def moment_inputs(B, n):
    """A two-aperture plan (rectangular, elliptical with x_max = inf) as the
    kernels take it, with plane centres, a cloud and 0/1 weights, float64."""
    specs = spec_list(B, SPECS["two apertures"] + SPECS["x_max = inf"])
    elements = [torch_element(s) for s in specs]
    plan = torch_fused.particle_moment_plan(
        elements, torch.tensor([1.073e8], dtype=torch.float64),
        lambda x: torch.broadcast_to(torch.as_tensor(x).reshape(-1), (B,)),
    )
    entries, extra = kernel_entries(*plan, B)
    scalars = tuple(torch.as_tensor(np.ascontiguousarray(s)) for s in extra)
    weights = (np.random.default_rng(5).uniform(size=n) > 0.05).astype(np.float64)
    return entries, scalars, torch.from_numpy(cloud(n)), torch.from_numpy(weights)


def test_particle_moment_sweep_matches_plain(host_kernels):
    B, n = 13, 1001  # ragged: neither a multiple of the block nor of the slots
    entries, scalars, particles, weights = moment_inputs(B, n)
    assert sum(e[0] == "aperture" for e in entries) == 4
    tape = fused_track._walk_tape(entries, torch.device("cpu"))
    stacked = torch.stack(scalars).contiguous()
    cloud_t = particles.t().contiguous()
    slots = fused_track._moment_slots(B, n)
    partials, scratch, out = fused_track._moment_workspace(B, slots, torch.float64, "cpu")
    code = host_kernels["particle_moment_sweep"].lynx_particle_moment_sweep(
        1, tape.records.data_ptr(), tape.records.shape[0], tape.literals.data_ptr(),
        stacked.data_ptr(), cloud_t.data_ptr(), weights.data_ptr(), partials.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, n, slots, None,
    )
    assert code == 0
    expected = fused_track._moment_sweep_reference(entries, scalars, particles, weights)
    assert 0 < float(expected[2].min()) < float(weights.sum())  # the apertures cut
    assert max(sums_errors(fused_track._walk_sums(out), expected)) <= RTOL


def packed_gram(host_kernels, operands, splits=None, dtype=torch.float64):
    """B6 on the host, as its wrapper launches it: ``(gram (B, 8, 8),
    splits)``, with the wrapper's splits unless ``splits`` is given."""
    apertures, planes, bounds, aug, w0 = operands
    B, n = planes.shape[1], aug.shape[1]
    library = host_kernels["packed_gram"]
    if splits is None:
        splits = library.lynx_packed_gram_splits(int(dtype == torch.float64), B, n)
    tape = fused_track._gram_tape(apertures, torch.device("cpu"))
    partials, scratch, out = fused_track._moment_workspace(B, splits, dtype, "cpu")
    code = library.lynx_packed_gram(
        int(dtype == torch.float64), tape.records.data_ptr(), len(apertures),
        tape.row_index.data_ptr(), tape.row_index.shape[0], planes.data_ptr(), bounds.data_ptr(),
        aug.data_ptr(), w0.data_ptr(), partials.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        B, n, splits, None,
    )
    assert code == 0
    index = [fused_track._upper(j, k, 8) for j in range(8) for k in range(8)]
    return out[:, index].reshape(B, 8, 8), splits


def gram_errors(gram, expected):
    """B6's (first, second) sums against the plain version's on the scales
    of :func:`sums_errors`, which asserts the weight sums equal."""
    return sums_errors(*[(g[:, 7, :7], g[:, :7, :7], g[:, 7, 7]) for g in (gram, expected)])


@pytest.mark.parametrize(
    "B, n, splits",
    [
        (17, 1001, None),  # the wrapper's splits: one 128-particle chunk each, the last ragged
        (33, 1001, 1),  # one split: eight chunks through the two stage buffers
        (1, 777, 2),  # one setting in a warp of 32; splits of 3 chunks, the last ragged
        (65, 1030, 3),  # settings in three warps; a ragged chunk of 6 particles
        (129, 300, 2),  # two tiles of settings, the second of one setting
    ],
)
def test_packed_gram_matches_plain(host_kernels, B, n, splits):
    """Two apertures, one with x_max = inf, an elliptical one, 0/1 weights;
    ragged B across the settings tile and ragged N across the chunks and
    the splits."""
    entries, scalars, particles, weights = moment_inputs(B, n)
    operands, _ = fused_track._packed_operands(entries, scalars, particles, weights)
    gram, used = packed_gram(host_kernels, operands, splits)
    assert splits is None or used == splits
    expected = fused_track.packed_gram_reference(*operands)
    assert 0 < float(expected[:, 7, 7].min()) < float(weights.sum())
    assert max(gram_errors(gram, expected)) <= RTOL


def test_packed_gram_all_lost_setting_and_no_aperture(host_kernels):
    """A setting whose aperture is closed loses every particle (its sums are
    exact zeros); a plan without apertures sums the whole cloud."""
    B, n = 20, 500
    entries, scalars, particles, weights = moment_inputs(B, n)
    operands, _ = fused_track._packed_operands(entries, scalars, particles, weights)
    apertures, planes, bounds, aug, w0 = operands
    bounds = bounds.clone()
    bounds[0, :, 4] = torch.tensor([1e-12, 1e-12, 1e24, 1e24], dtype=torch.float64)
    operands = (apertures, planes, bounds, aug, w0)
    gram, _ = packed_gram(host_kernels, operands, splits=2)
    expected = fused_track.packed_gram_reference(*operands)
    assert float(expected[4, 7, 7]) == 0 and bool((gram[4] == 0).all())
    assert max(gram_errors(gram, expected)) <= RTOL

    none = ((), planes[:0].contiguous(), bounds[:0].contiguous(), aug, w0)
    gram, _ = packed_gram(host_kernels, none)
    expected = fused_track.packed_gram_reference(*none)
    assert torch.equal(gram[:, 7, 7], expected[:, 7, 7])
    assert max(gram_errors(gram, expected)) <= RTOL


def test_gram_tape_takes_ascending_plane_rows():
    """B6 sums a plane over its aug rows in ascending order, as the plain
    version sums them in the order given: the tape refuses any other."""
    for rows in ((1, 0, 7), (0, 0, 7), (0, 8)):
        with pytest.raises(ValueError, match="ascending"):
            fused_track._gram_tape((("rectangular", rows, (2, 7)),), torch.device("cpu"))


def test_packed_gram_refuses_operands_past_the_shared_memory(host_kernels):
    """A block stages its settings' plane coefficients and bounds, 20 values
    a setting and aperture: a plan whose apertures exceed the 227 KB of an
    H100 block returns the code that the wrapper raises on, before the
    kernel reads any operand."""
    launch = host_kernels["packed_gram"].lynx_packed_gram
    for is_double, apertures in ((0, 30), (1, 15)):
        assert launch(is_double, None, apertures, None, 0, *[None] * 7, 256, 1000, 1, None) == (
            fused_track._B6_DOES_NOT_FIT
        )


@pytest.mark.parametrize("B, n, splits", [(40, 600, 3), (1, 300, 1), (129, 200, None)])
def test_packed_gram_float_tiles(host_kernels, B, n, splits):
    """The float build, the Gram on the tensor cores (the host stand-in of
    mma.sync forms each fragment's tile products from the warp's lanes):
    within float rounding of the plain version in float64 on the same
    rounded inputs, and no net flip of survivors on this cloud; warps of 16
    settings, ragged, one or three splits."""
    entries, scalars, particles, weights = moment_inputs(B, n)
    operands, _ = fused_track._packed_operands(entries, scalars, particles, weights)
    single = tuple(x.float().contiguous() if isinstance(x, torch.Tensor) else x for x in operands)
    gram, _ = packed_gram(host_kernels, single, splits, dtype=torch.float32)
    rounded = tuple(x.double() if isinstance(x, torch.Tensor) else x for x in single)
    expected = fused_track.packed_gram_reference(*rounded)
    assert max(gram_errors(gram.double(), expected)) <= 1e-5


@pytest.mark.parametrize("is_double", [0, 1])
def test_gram_splits_fill_the_card(host_kernels, is_double):
    """B6's launch shape: tiles of 16 settings a warp (float) or 32 (double),
    at most 128; splits of whole 128-particle chunks, none empty, enough for
    16 warps on each of 132 SMs where the cloud allows (at least half of
    that: a split takes whole chunks)."""
    splits_of = host_kernels["packed_gram"].lynx_packed_gram_splits
    unit = 32 if is_double else 16  # settings a warp
    for B, N in ((16, 100_000), (256, 100_000), (17, 1001), (1000, 100_003), (3, 5)):
        tile = min(128, -(-B // unit) * unit)
        splits = splits_of(is_double, B, N)
        chunks = -(-N // 128)
        per_split = -(-chunks // splits)
        assert (splits - 1) * per_split < chunks <= splits * per_split
        warps = -(-B // tile) * (tile // unit)
        assert 2 * warps * splits >= 132 * 16 or splits == chunks
    # Path A's launch: 2 tiles of 8 warps (float), 131 splits of 6 chunks.
    assert splits_of(0, 256, 100_000) == 131
