"""The CUDA sources of kernels B1-B8 and B10, run on the CPU.

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
indexing and barriers; B6's and B7's ``mma.sync`` (m16n8k16 bf16, m16n8k32
s8) form each lane's outputs from the warp's fragments in the PTX ISA's
layouts; ``atomicAdd`` is a host atomic.  A thread-block cluster launch
(``cudaLaunchKernelEx``) runs all threads of a cluster's blocks at once,
``cluster.sync()`` a barrier over them and ``map_shared_rank`` the same
offset in the other block's dynamic shared memory, so that B7's
distributed shared window runs on the CPU too.  That runs the kernels'
arithmetic and their cooperation (tape decoding, builders, dual numbers,
shared-memory tiles, the ragged batch, cluster windows) on the plain
versions' inputs.  B1's bins are held bit for bit, and its count-mode
images exactly; its weighted images within 1e-5 relative per cell (float
atomics sum in any order).  What it cannot check is the device
itself (FMA contraction, memory, occupancy, registers): ``chip_smoke.py``
does that on the card.

Bounds, float64: B3, B2 and B8 within 1e-12 of their plain versions relative
to each setting's largest entry, B10 to each row's of a setting's map (B8
and B10 in float within 1e-5: the builders' transcendentals come from the
host's libm there and from PyTorch's in the plain version); B5 and B6 within 1e-12, second moments
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
from lynx_tpu_torch.benchmarks import hist_ab
from lynx_tpu_torch.constants import ELECTRON_MASS_EV, REST_ENERGY_EV
from lynx_tpu_torch.ops import fused_track
from lynx_tpu_torch.ops import histogram as torch_hist
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
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstring>
#include <cstdint>
#include <memory>
#include <new>
#include <thread>
#include <tuple>
#include <type_traits>
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
static thread_local HostDim3 threadIdx, blockIdx;
static HostDim3 blockDim, gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) double2 { double x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
// Threads of a block run concurrently: atomics are atomic.
inline int atomicAdd(int* address, int value) {
  return __atomic_fetch_add(address, value, __ATOMIC_RELAXED);
}
inline float atomicAdd(float* address, float value) {
  return std::atomic_ref<float>(*address).fetch_add(value, std::memory_order_relaxed);
}
inline double atomicAdd(double* address, double value) {
  return std::atomic_ref<double>(*address).fetch_add(value, std::memory_order_relaxed);
}
inline int atomicMax(int* address, int value) {
  std::atomic_ref<int> cell(*address);
  int old = cell.load(std::memory_order_relaxed);
  while (old < value && !cell.compare_exchange_weak(old, value, std::memory_order_relaxed)) {}
  return old;
}
inline int atomicMin(int* address, int value) {
  std::atomic_ref<int> cell(*address);
  int old = cell.load(std::memory_order_relaxed);
  while (old > value && !cell.compare_exchange_weak(old, value, std::memory_order_relaxed)) {}
  return old;
}
// The _rn arithmetic: x86-64 SSE rounds each operation to nearest, and
// -std=c++20 contracts nothing.
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline double2 make_double2(double x, double y) { return {x, y}; }
static thread_local std::barrier<>* lynx_host_barrier = nullptr;
static thread_local unsigned char* lynx_host_shared = nullptr;
inline void __syncthreads() { lynx_host_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { lynx_host_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributeNonPortableClusterSizeAllowed = 10 };
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
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// __shfl_xor_sync: each lane leaves its value in its warp's slot; after a
// barrier it reads its partner's, and a second barrier frees the slots.
struct LynxHostShfl { double v[32]; };
static LynxHostShfl lynx_host_shfl[32];
template <typename T> inline T lynx_shfl_xor(T value, int mask) {
  LynxHostShfl& slot = lynx_host_shfl[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  slot.v[lane] = static_cast<double>(value);
  lynx_host_barrier->arrive_and_wait();
  const T out = static_cast<T>(slot.v[lane ^ static_cast<unsigned>(mask)]);
  lynx_host_barrier->arrive_and_wait();
  return out;
}
// __vcmpeq4: 0xff in each byte where the two words' bytes are equal, else 0.
inline unsigned lynx_vcmpeq4(unsigned a, unsigned b) {
  unsigned out = 0;
  for (int i = 0; i < 4; ++i) {
    if (((a >> (8 * i)) & 0xffu) == ((b >> (8 * i)) & 0xffu)) out |= 0xffu << (8 * i);
  }
  return out;
}
// __byte_perm: byte i of the result is byte (s >> 4 i) & 7 of the pair
// (a in bytes 0-3, b in bytes 4-7).
inline unsigned lynx_byte_perm(unsigned a, unsigned b, unsigned s) {
  const unsigned long long pool = (static_cast<unsigned long long>(b) << 32) | a;
  unsigned out = 0;
  for (int i = 0; i < 4; ++i) out |= ((pool >> (8 * ((s >> (4 * i)) & 7u))) & 0xffu) << (8 * i);
  return out;
}
// __popcll: the set bits of a 64-bit word.
inline int lynx_popcount(unsigned long long x) { return __builtin_popcountll(x); }
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
// mma.sync m16n8k32 s8 -> s32: as lynx_mma_bf16, with the s8 fragment
// layouts (four s8 values to a register, element i in byte i).
struct LynxHostMmaS8 { unsigned a[32][4]; unsigned b[32][2]; };
static LynxHostMmaS8 lynx_host_mma_s8[32];
inline int lynx_host_s8(unsigned word, int i) {
  return static_cast<int>(static_cast<signed char>((word >> (8 * i)) & 0xffu));
}
inline void lynx_mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  LynxHostMmaS8& slot = lynx_host_mma_s8[threadIdx.x / 32];
  const unsigned lane = threadIdx.x % 32;
  for (int r = 0; r < 4; ++r) slot.a[lane][r] = a[r];
  for (int r = 0; r < 2; ++r) slot.b[lane][r] = b[r];
  lynx_host_barrier->arrive_and_wait();
  for (int c = 0; c < 4; ++c) {
    const int row = lane / 4 + 8 * (c / 2);
    const int col = 2 * (lane % 4) + c % 2;
    int acc = d[c];
    for (int k = 0; k < 32; ++k) {
      // A: register (row / 8) + 2 (k / 16) of lane 4 (row % 8) + (k % 16) / 4;
      // B: register k / 16 of lane 4 col + (k % 16) / 4; byte k % 4.
      const int x = lynx_host_s8(slot.a[4 * (row % 8) + (k % 16) / 4][row / 8 + 2 * (k / 16)], k % 4);
      const int y = lynx_host_s8(slot.b[4 * col + (k % 16) / 4][k / 16], k % 4);
      acc += x * y;
    }
    d[c] = acc;
  }
  lynx_host_barrier->arrive_and_wait();
}
template <typename F>
void lynx_host_launch(F body, dim3 grid, unsigned threads, size_t shared = 0,
                      cudaStream_t = nullptr) {
  void* memory = ::operator new(shared + 16, std::align_val_t(16));
  unsigned char* buffer = static_cast<unsigned char*>(memory);
  gridDim = {grid.x, grid.y, 1};
  blockDim = {threads, 1, 1};
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned b = 0; b < grid.x; ++b) {
      std::barrier<> barrier(threads);
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t) {
        pool.emplace_back([&body, &barrier, buffer, t, b, by] {
          threadIdx = {t, 0, 0};
          blockIdx = {b, by, 0};
          lynx_host_barrier = &barrier;
          lynx_host_shared = buffer;
          body();
        });
      }
      for (auto& thread : pool) thread.join();
    }
  }
  ::operator delete(memory, std::align_val_t(16));
}
inline cudaError_t cudaMemsetAsync(void* address, int value, size_t bytes, cudaStream_t = nullptr) {
  std::memset(address, value, bytes);
  return 0;
}
// Thread-block clusters: the blocks of one cluster run together, each
// thread a std::thread; clusters run one after another.  cluster.sync() is
// a barrier over all of a cluster's threads; map_shared_rank maps an
// address in the block's dynamic shared memory to the same offset in
// another block's.
enum { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  int id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
struct LynxHostCluster {
  std::barrier<>* barrier;
  unsigned char* const* shared;
  unsigned rank, blocks;
};
static thread_local LynxHostCluster lynx_host_cluster;
inline unsigned lynx_host_cluster_size(const cudaLaunchConfig_t* config) {
  for (unsigned i = 0; i < config->numAttrs; ++i) {
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      return config->attrs[i].val.clusterDim.x;
    }
  }
  return 1;
}
template <typename F>
cudaError_t cudaOccupancyMaxActiveClusters(int* clusters, F, const cudaLaunchConfig_t* config) {
  const unsigned size = lynx_host_cluster_size(config);
  *clusters = config->dynamicSmemBytes <= static_cast<size_t>(kHostSharedOptin) && size <= 16
                  ? static_cast<int>(132 / size) : 0;
  return 0;
}
template <typename... Params, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config, void (*kernel)(Params...),
                               Args&&... args) {
  const std::tuple<std::decay_t<Params>...> params(std::forward<Args>(args)...);
  const unsigned size = lynx_host_cluster_size(config);
  const unsigned threads = config->blockDim.x;
  if (config->gridDim.x % size != 0) return cudaErrorInvalidConfiguration;
  gridDim = {config->gridDim.x, config->gridDim.y, 1};
  blockDim = {threads, 1, 1};
  for (unsigned by = 0; by < config->gridDim.y; ++by) {
    for (unsigned first = 0; first < config->gridDim.x; first += size) {
      std::barrier<> cluster_barrier(size * threads);
      std::vector<std::unique_ptr<std::barrier<>>> barriers;
      std::vector<unsigned char*> buffers;
      for (unsigned r = 0; r < size; ++r) {
        barriers.push_back(std::make_unique<std::barrier<>>(threads));
        buffers.push_back(static_cast<unsigned char*>(
            ::operator new(config->dynamicSmemBytes + 16, std::align_val_t(16))));
      }
      std::vector<std::thread> pool;
      for (unsigned r = 0; r < size; ++r) {
        for (unsigned t = 0; t < threads; ++t) {
          pool.emplace_back([&, r, t] {
            threadIdx = {t, 0, 0};
            blockIdx = {first + r, by, 0};
            lynx_host_barrier = barriers[r].get();
            lynx_host_shared = buffers[r];
            lynx_host_cluster = {&cluster_barrier, buffers.data(), r, size};
            std::apply(kernel, params);
          });
        }
      }
      for (auto& thread : pool) thread.join();
      for (auto* buffer : buffers) ::operator delete(buffer, std::align_val_t(16));
    }
  }
  return 0;
}
"""

COOPERATIVE_GROUPS = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { lynx_host_cluster.barrier->arrive_and_wait(); }
  unsigned block_rank() const { return lynx_host_cluster.rank; }
  unsigned num_blocks() const { return lynx_host_cluster.blocks; }
  template <typename T> T* map_shared_rank(T* address, unsigned rank) const {
    const auto offset = reinterpret_cast<unsigned char*>(address) -
                        lynx_host_cluster.shared[lynx_host_cluster.rank];
    return reinterpret_cast<T*>(lynx_host_cluster.shared[rank] + offset);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

SIGNATURES = {
    "moment_sweep": fused_track._B3_SIGNATURE,
    "moment_sweep_bwd": fused_track._B4_SIGNATURE,
    "particle_apply": fused_track._B2_SIGNATURE,
    "particle_push": fused_track._B8_SIGNATURE,
    "map_fold": fused_track._B10_SIGNATURE,
    "particle_moment_sweep": fused_track._B5_SIGNATURE,
    "packed_gram": fused_track._B6_SIGNATURE,
    "hist_ab": hist_ab._B7_SIGNATURE,
    "window_histogram": torch_hist._B1_SIGNATURE,
}
# kernel<T, ...><<<grid>>>(args); -> lynx_host_launch([&] { kernel<T, ...>(args); }, grid);
LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", flags=re.S)
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
    (root / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS)
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
    times over) as B3 and B4 take it: ``(entries, values, energy, mu, cov,
    k1_zero)``, float64."""
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
    return entries, values, energy, mu, cov, k1_zero


def cotangents(B):
    """The moments' cotangents (dmu, dcov) of the backward checks."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.normal(size=(B, 7))), torch.from_numpy(rng.normal(size=(B, 7, 7)))


def run_backward(host_kernels, entries, values, energy, mu, cov, dmu, dcov, wanted=None):
    """B4 on the host, float64, through the wrapper's own marshalling
    (``fused_track._sweep_vjp_launch``): ``(d_values, d_energy, d_mu,
    d_cov)``, None where not asked for.  ``wanted``: one flag per value,
    then the energy, mu and cov (None: every input)."""
    if wanted is None:
        wanted = (True,) * (len(values) + 3)
    return fused_track._sweep_vjp_launch(host_kernels["moment_sweep_bwd"], entries, values,
                                         energy, mu, cov, dmu, dcov, tuple(wanted), None)


def plain_value_forward(entries, values, energy, mu, cov, dmu, dcov, index):
    """The plain version's cotangent of value ``index`` in forward mode: the
    moments' derivatives along it, contracted with their cotangents per
    setting (summed over the settings for a value they share)."""
    import torch.autograd.forward_ad as fwAD

    B = energy.shape[0]
    values = [v.detach() for v in values]
    with fwAD.dual_level():
        values[index] = fwAD.make_dual(values[index], torch.ones_like(values[index]))
        outputs = fused_track._table_reference_sweep(entries, values, energy, mu, cov)
        tmu, tcov = (fwAD.unpack_dual(t).tangent for t in outputs)
    total = (dmu * tmu).sum(dim=1) + (dcov * tcov).reshape(B, -1).sum(dim=1)
    return total if values[index].shape[0] == B else total.sum().reshape(1)


def check_backward(host_kernels, B, entries, values, energy, mu, cov, k1_zero,
                   energy_rtol=RTOL, rtol=RTOL, wanted=None, forward=False):
    """B4 against autograd of the plain sweep, at the module's bounds (or
    ``rtol``; the energy cotangent at ``energy_rtol``), with the cotangents
    ``wanted`` asked for (None: all); the others None on both sides.  With
    ``forward``, a value past the bound is held instead to the plain
    version's forward mode (B4 differentiates its builders in forward
    mode), where the plain version's own two modes differ by more than the
    bound.  Returns B4's cotangents."""
    dmu, dcov = cotangents(B)
    got = run_backward(host_kernels, entries, values, energy, mu, cov, dmu, dcov, wanted)
    ref_values, *ref_rest = fused_track._reference_sweep_vjp(
        entries, values, energy, mu, cov, dmu, dcov, wanted
    )
    offset = 0
    for kind, meta, count in entries:
        for k in range(count):
            got_value, want = got[0][offset + k], ref_values[offset + k]
            assert (got_value is None) == (want is None), (kind, offset + k)
            if want is None:
                continue
            want = want.reshape(got_value.shape)
            scale = float(want.abs().max())
            error = (got_value - want).abs()
            if meta is torch_fused._build_quadrupole and k == 1 and want.dim():
                # d/dk1 at k1 == 0 is rounding-limited (module docstring).
                zero = k1_zero if want.shape[0] == B else torch.zeros_like(k1_zero)
                assert bool((error[zero] <= K1_ZERO_RTOL * want[zero].abs()).all())
                error = error[~zero]
            if forward and float(error.max()) > rtol * scale:
                modes = plain_value_forward(entries, values, energy, mu, cov, dmu, dcov,
                                            offset + k).reshape(got_value.shape)
                assert float((modes - want).abs().max()) > rtol * scale, (kind, offset + k)
                error = (got_value - modes).abs()
            assert float(error.max()) <= rtol * scale, (kind, offset + k)
        offset += count
    for name, got_value, want, bound in zip(("d_energy", "d_mu", "d_cov"), got[1:], ref_rest,
                                            (energy_rtol, rtol, rtol)):
        assert (got_value is None) == (want is None), name
        if want is not None:
            assert float((got_value - want).abs().max()) <= bound * float(want.abs().max()), name
    return got


@pytest.mark.parametrize("energy_batched", [False, True])
def test_moment_sweep_and_backward_match_plain(host_kernels, energy_batched):
    B = 37  # ragged: not a multiple of B3's and B4's 64-setting blocks
    plan = sweep_plan(B, energy_batched)
    entries, values, energy, mu, cov, _ = plan
    assert B % host_kernels["moment_sweep_bwd"].lynx_moment_sweep_bwd_block()

    out_mu, out_cov = run_sweep(host_kernels, entries, values, energy, mu, cov)
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
        1, int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0], params.data_ptr(),
        consts.data_ptr(), energy.data_ptr(), mu.data_ptr(), cov.data_ptr(), out_mu.data_ptr(),
        out_cov.data_ptr(), B, REST_ENERGY_EV, ELECTRON_MASS_EV, None,
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


def test_backward_layout_follows_the_tape_and_the_mask(host_kernels):
    """B4 keeps the state entering each entry that has an input asked for
    (mu and Sigma's upper triangle, 35 values a setting) in a workspace
    slot, in tape order, and its forward pass walks through the last such
    entry only; its outputs have a row per value asked for, dynamic values
    in ``d_params``, const cells in ``d_consts``; a dynamic entry's bit past
    its parameters asks for the energy.  On :func:`sweep_plan`'s tape
    (const, quadrupole, const, two correctors, const, drift), each mask."""
    library = host_kernels["moment_sweep_bwd"]
    assert library.lynx_moment_sweep_bwd_state() == fused_track.B4_STATE == 35
    assert library.lynx_moment_sweep_bwd_block() == 64
    entries, values, *_ = sweep_plan(8, energy_batched=False)
    cpu = torch.device("cpu")
    assert [kind if kind == "const" else meta.tape_kind for kind, meta, _ in entries] == [
        "const", fused_track.TAPE_QUAD, "const", fused_track.TAPE_HCOR, fused_track.TAPE_VCOR,
        "const", fused_track.TAPE_DRIFT]
    counts = [count for _, _, count in entries]
    assert counts == [3, 5, 3, 2, 2, 30, 1]

    def rows(layout):
        return [((hi << 32) | (lo & 0xFFFFFFFF), row, slot)
                for lo, hi, row, slot in layout.wants.tolist()]

    every = fused_track._vjp_layout(entries, cpu, (True,) * 46, True)
    drift_cells = (1 << 1) | (1 << 17) | (1 << 33)  # (0, 1), (2, 3), (4, 5)
    got = rows(every)
    assert got[:5] == [(drift_cells, 0, 0), (0b111111, 0, 1), (drift_cells, 3, 2), (0b111, 5, 3),
                       (0b111, 7, 4)]
    assert bin(got[5][0]).count("1") == 30 and got[5][1:] == (6, 5)
    assert got[6] == (0b11, 9, 6)
    assert (every.slots, every.forward, every.param_rows, every.const_rows, every.cotangents) == (
        7, 7, 10, 36, 47)

    # The tuner's: k1 and the correctors' angles, nothing else.
    tuner = [False] * 46
    for index in (3 + 1, 11 + 1, 13 + 1):
        tuner[index] = True
    layout = fused_track._vjp_layout(entries, cpu, tuner, False)
    assert rows(layout) == [(0, 0, -1), (0b10, 0, 0), (0, 0, -1), (0b10, 1, 1), (0b10, 2, 2),
                            (0, 0, -1), (0, 3, -1)]
    assert (layout.slots, layout.forward, layout.param_rows, layout.const_rows,
            layout.cotangents) == (3, 5, 3, 0, 3)

    # The energy alone: a bit past each dynamic entry's parameters.
    layout = fused_track._vjp_layout(entries, cpu, [False] * 46, True)
    assert [bits for bits, _, _ in rows(layout)] == [0, 1 << 5, 0, 1 << 2, 1 << 2, 0, 1 << 1]
    assert (layout.slots, layout.forward, layout.param_rows, layout.cotangents) == (4, 7, 0, 1)

    # The moments alone: no state, no forward pass.
    layout = fused_track._vjp_layout(entries, cpu, [False] * 46, False)
    assert (layout.slots, layout.forward, layout.param_rows, layout.const_rows,
            layout.cotangents) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("B, repeat", [(5, 4), (37, 4), (5, 25)])
def test_backward_on_long_tapes(host_kernels, B, repeat):
    """The run ``repeat`` times over, every entry dynamic: 36 and 225
    entries, the markers' and screens' identity entries without a state, so
    7 states a repeat in the workspace; B = 37 fills one block of 64
    settings in part, B = 5 a few threads of it."""
    plan = sweep_plan(B, energy_batched=True, repeat=repeat)
    entries, values = plan[:2]
    assert len(entries) == 9 * repeat
    layout = fused_track._vjp_layout(entries, torch.device("cpu"), (True,) * len(values), True)
    assert layout.slots == 7 * repeat and layout.forward == 9 * repeat - 1
    check_backward(host_kernels, B, *plan)


def one_field_a_dynamic_entry(entries):
    """The tuner's mask over a plan's values: one value of each dynamic
    entry (a quadrupole's k1, a corrector's or dipole's angle, a solenoid's
    k, a cavity's voltage, a drift's length, a custom map's cell (0, 1)),
    no const cell, and neither the energy nor the moments."""
    wanted = []
    for kind, _, count in entries:
        wanted += [kind == "dyn" and k == min(1, count - 1) for k in range(count)]
    return wanted


MASKS = {
    "tuner": lambda entries, n: one_field_a_dynamic_entry(entries) + [False, False, False],
    "energy": lambda entries, n: [False] * n + [True, False, False],
    "const cells": lambda entries, n: [kind == "const" for kind, _, count in entries
                                       for _ in range(count)] + [False, False, True],
    "moments": lambda entries, n: [False] * n + [False, True, True],
    "every other value": lambda entries, n: [k % 2 == 0 for k in range(n)] + [True, True, False],
}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_backward_forms_only_the_cotangents_asked_for(host_kernels, mask):
    """A mask asks B4 for some cotangents: those come back equal to the
    all-inputs launch's, bit for bit, and within the module's bounds of the
    plain version asked for the same; the others come back None.  On the
    paths' plan and on the full kinds' (const groups between), ragged B."""
    for entries, values, energy, mu, cov, k1_zero in (sweep_plan(37, False),
                                                      new_kind_plan(37, False)):
        B = mu.shape[0]
        wanted = MASKS[mask](entries, len(values))
        dmu, dcov = cotangents(B)
        every = run_backward(host_kernels, entries, values, energy, mu, cov, dmu, dcov)
        some = check_backward(host_kernels, B, entries, values, energy, mu, cov, k1_zero,
                              energy_rtol=1e-9, wanted=wanted)
        for flag, got, full in zip(wanted, (*some[0], *some[1:]), (*every[0], *every[1:])):
            assert (got is not None) == flag
            if flag:
                assert torch.equal(got, full)


def test_backward_asks_for_what_autograd_needs(host_kernels, monkeypatch):
    """The tuner's case through autograd: only the quadrupoles' k1 and the
    correctors' angles require a gradient, the energy and every static
    element none.  ``_FusedMomentSweep.backward`` asks B4 (its host build
    standing in for the CPU's plain version) for those cotangents and the
    moments' alone, one a dynamic entry; the gradients equal the plain
    version's within the module's bound; the counters count the tape's 46
    inputs (its values and the energy) and the 3 differentiated."""
    B = 37
    entries, values, energy, mu, cov, k1_zero = sweep_plan(B, energy_batched=False)
    tuned = {3 + 1, 11 + 1, 13 + 1}  # the quadrupole's k1 and the correctors' angles
    leaves = [v.detach().clone().requires_grad_(i in tuned) for i, v in enumerate(values)]
    mu_in = mu.clone().requires_grad_(True)
    plan = []
    offset = 0
    for kind, meta, count in entries:
        plan.append((kind, meta, leaves[offset:offset + count]))
        offset += count
    dmu, dcov = cotangents(B)

    def gradients():
        out_mu, out_cov = fused_track.fused_moment_sweep_plan(plan, energy, mu_in, cov)
        asked = [leaves[i] for i in sorted(tuned)] + [mu_in]
        return torch.autograd.grad((out_mu, out_cov), asked, (dmu, dcov))

    want = gradients()
    seen = []

    def host_vjp(entries, flat_values, energy, mu, cov, dmu, dcov, wanted):
        seen.append(wanted)
        return run_backward(host_kernels, entries, [v.detach() for v in flat_values],
                            energy.detach(), mu.detach(), cov.detach(), dmu, dcov, wanted)

    monkeypatch.setattr(fused_track, "_reference_sweep_vjp", host_vjp)
    counts = (fused_track.moment_sweep_bwd.launches, fused_track.moment_sweep_bwd.cotangents,
              fused_track.moment_sweep_bwd.inputs)
    got = gradients()
    assert seen == [tuple(i in tuned for i in range(46)) + (False, True, False)]
    assert (fused_track.moment_sweep_bwd.launches, fused_track.moment_sweep_bwd.cotangents,
            fused_track.moment_sweep_bwd.inputs) == (counts[0] + 1, counts[1] + 3, counts[2] + 47)
    for k, (g, w) in enumerate(zip(got, want)):
        error = (g - w).abs()
        if k == 0:  # d/dk1 at k1 == 0 is rounding-limited (module docstring)
            assert bool((error[k1_zero] <= K1_ZERO_RTOL * w[k1_zero].abs()).all())
            error = error[~k1_zero]
        assert float(error.max()) <= RTOL * float(w.abs().max())


def cycled_plan(B, n_entries):
    """A tape of exactly ``n_entries`` entries at one energy: pairs of a
    static drift (a const entry) and a batched element of each kind in turn
    (the paths' quadrupole, correctors and drift, then the full lattice's
    kinds of :func:`new_kind_elements`), a static drift last where the
    count is odd, float64; ``(entries, values, energy, mu, cov, k1_zero)``."""
    rng = np.random.default_rng(n_entries)
    f64 = dict(dtype=torch.float64)

    def u(low, high, *shape):
        return torch.from_numpy(rng.uniform(low, high, shape or (B,)))

    batched = []
    cycle = 0
    while len(batched) < n_entries // 2:
        batched += [
            ltt.Quadrupole(u(0.1, 0.3), k1=u(0.5, 5.0) * np.sign(cycle % 2 - 0.5),
                           tilt=u(-0.1, 0.1), misalignment=u(-2e-4, 2e-4, B, 2), **f64),
            ltt.HorizontalCorrector(u(0.05, 0.2), angle=u(-1e-3, 1e-3), **f64),
            ltt.VerticalCorrector(u(0.05, 0.2), angle=u(-1e-3, 1e-3), **f64),
            ltt.Drift(u(0.1, 0.5), **f64),
            *new_kind_elements(B, seed=cycle)[1::2],
        ]
        cycle += 1
    elements = []
    for element in batched[:n_entries // 2]:
        elements += [ltt.Drift(torch.tensor([float(rng.uniform(0.1, 0.5))], **f64), **f64),
                     element]
    if n_entries % 2:
        elements.append(ltt.Drift(torch.tensor([0.25], **f64), **f64))
    builders = [torch_fused.element_map_builder(el) for el in elements]
    energy = torch.full((B,), 1.073e8, **f64)
    plan = torch_fused.plan_run(builders, energy[:1], lambda x: torch.broadcast_to(x, (B,)))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v for _, _, vs in plan for v in vs]
    assert len(entries) == n_entries
    mu = torch.from_numpy(
        np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1))
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    return entries, values, energy, mu, torch.from_numpy(a @ np.swapaxes(a, 1, 2)), \
        torch.zeros(B, dtype=bool)


@pytest.mark.parametrize("n_entries", [0, 1, 11, 58, 225])
def test_backward_on_tapes_of_any_length(host_kernels, n_entries):
    """Tapes of 0 (the moments' cotangents pass through), 1 (one const
    entry), 11 (path T's length), 58 (the full tuner's longest run) and 225
    entries over every kind, the full kinds' builders from 11 on, at a
    ragged B = 70 (a full 64-setting block and 6 settings of a second):
    every input and the tuner's mask, against the plain version; the
    counters count each launch's inputs and cotangents.  On 225 entries the
    plain version's reverse mode loses digits on two dipoles' tilt (its own
    forward mode differs from it by up to ~1e-10 of the largest there):
    those are held to the forward mode."""
    B = 70
    plan = cycled_plan(B, n_entries)
    entries, values = plan[:2]
    n = len(values)
    assert fused_track._tape(entries, torch.device("cpu")).full == (n_entries >= 11)
    for wanted in (None, one_field_a_dynamic_entry(entries) + [False, True, True]):
        before = (fused_track.moment_sweep_bwd.cotangents, fused_track.moment_sweep_bwd.inputs)
        check_backward(host_kernels, B, *plan, energy_rtol=1e-9, wanted=wanted, forward=True)
        asked = n + 1 if wanted is None else sum(wanted[:n + 1])
        assert fused_track.moment_sweep_bwd.cotangents == before[0] + asked
        assert fused_track.moment_sweep_bwd.inputs == before[1] + n + 1
    assert sum(one_field_a_dynamic_entry(entries)) == n_entries // 2


def new_kind_elements(B, seed=4):
    """One batched element of each kind of the full lattice between static
    drifts, float64: a dipole with non-zero e1, e2, tilt, fint and gap and
    one at length 0, an RBend, a misaligned solenoid and one at k = 0, an
    inactive cavity with batched length, phase and frequency, an undulator
    and a custom map."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64)

    def u(low, high, *shape):
        return torch.from_numpy(rng.uniform(low, high, shape or (B,)))

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


def new_kind_plan(B, energy_batched):
    """The plan of :func:`new_kind_elements` as B3 and B4 take it (see
    :func:`sweep_plan`); no quadrupole, so no k1 = 0 entry.  Also returns the
    tape."""
    builders = [torch_fused.element_map_builder(el) for el in new_kind_elements(B)]
    rng = np.random.default_rng(6)
    energy = torch.full((B,), 1.073e8, dtype=torch.float64)
    if energy_batched:  # every element dynamic, the drifts and the custom map too
        energy = energy * torch.linspace(0.9, 1.1, B, dtype=torch.float64)
    plan = torch_fused.plan_run(builders, energy if energy_batched else energy[:1],
                                lambda x: torch.broadcast_to(x, (B,)))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v for _, _, vs in plan for v in vs]
    mu = torch.from_numpy(
        np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1))
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    cov = torch.from_numpy(a @ np.swapaxes(a, 1, 2))
    return entries, values, energy, mu, cov, torch.zeros(B, dtype=bool)


@pytest.mark.parametrize("B, energy_batched", [(37, False), (5, True)])
def test_new_builders_match_plain(host_kernels, B, energy_batched):
    """B3 and B4 on one batched element of each new kind: the kernels'
    instantiation with the full lattice's builders (the dipole's 9 inputs
    in two dual passes, the custom map's cells as parameters) against the
    plain versions.  The energy cotangent sums the 16 maps' contributions,
    which cancel to ~1e-17 here: the two summation orders agree to 1e-10 of
    it, 1e-12 of the contributions."""
    plan = new_kind_plan(B, energy_batched)
    entries, values, energy, mu, cov, _ = plan
    tape = fused_track._tape(entries, torch.device("cpu"))
    assert tape.full
    kinds = {row[0] for row in tape.rows.tolist()}
    assert {fused_track.TAPE_DIPOLE, fused_track.TAPE_SOLENOID, fused_track.TAPE_CAVITY,
            fused_track.TAPE_UNDULATOR, fused_track.TAPE_CUSTOM} <= kinds
    out_mu, out_cov = run_sweep(host_kernels, entries, values, energy, mu, cov)
    ref_mu, ref_cov = fused_track._table_reference_sweep(entries, values, energy, mu, cov)
    assert per_setting_error(out_mu, ref_mu) <= RTOL
    assert per_setting_error(out_cov, ref_cov) <= RTOL
    check_backward(host_kernels, B, *plan, energy_rtol=1e-9)


@pytest.mark.parametrize("B, energy_batched", [(37, False), (5, True)])
def test_new_builders_energy_cotangent_is_the_forward_mode(host_kernels, B, energy_batched):
    """B4's energy cotangent comes from dual numbers, a forward mode.  On the
    new kinds it equals the plain version's forward mode per setting to
    1e-12 of the value, while the plain version's reverse mode differs from
    both by the inactive cavity's cancelling d/dE: ``chip_smoke.py`` holds
    the kernel to its reverse mode within SPREAD_FACTOR times that spread."""
    import chip_smoke

    plan = new_kind_plan(B, energy_batched)
    entries, values, energy, mu, cov, _ = plan
    dmu, dcov = cotangents(B)
    got = run_backward(host_kernels, entries, values, energy, mu, cov, dmu, dcov)[1]
    forward = chip_smoke.plain_energy_forward(torch, fused_track, entries, values, energy, mu,
                                              cov, dmu, dcov)
    reverse = fused_track._reference_sweep_vjp(entries, values, energy, mu, cov, dmu, dcov)[1]
    assert float(((got - forward).abs() / forward.abs()).max()) <= RTOL
    assert chip_smoke.energy_ratio(torch, got, reverse, RTOL, forward)[0] <= 1
    if not energy_batched:  # one energy: the cavity's rounding outweighs the value
        assert chip_smoke.energy_ratio(torch, got, reverse, RTOL)[0] > 1


@pytest.mark.parametrize("seed", range(16))
def test_backward_on_path_v_random_lattices(host_kernels, seed, monkeypatch):
    """B4 in path V2's sweep on the CPU: ``chip_smoke.random_sweep`` of the
    JAX suite's random lattice of ``seed`` at 64 settings, every field per
    setting, with B4's source standing in for the plain version in each
    run's backward, against the plain version's gradients: on the loss's
    scale at ``DOUBLE_RTOL`` and per field at ``FIELD_RTOL``, V2's bounds."""
    import chip_smoke
    from lynx_tpu_torch import functional
    from lynx_tpu_torch.accelerator import segment as segment_module

    def host_vjp(entries, flat_values, energy, mu, cov, dmu, dcov, wanted):
        return run_backward(host_kernels, entries, [v.detach() for v in flat_values],
                            energy.detach().contiguous(), mu.detach().contiguous(),
                            cov.detach().contiguous(), dmu.contiguous(), dcov.contiguous(),
                            wanted)

    monkeypatch.setattr(segment_module, "FUSED_SWEEP_PATH", True)
    monkeypatch.setattr(segment_module, "PALLAS_SWEEP_THRESHOLD", 1)
    lattice, settings, _, tuned, plain = chip_smoke.random_sweep(
        torch, ltt, functional, seed, 64, "cpu")
    monkeypatch.setattr(fused_track, "_reference_sweep_vjp", host_vjp)
    *_, kernel = chip_smoke.random_sweep(torch, ltt, functional, seed, 64, "cpu",
                                         settings=settings)
    common, own, small = chip_smoke.gradient_errors(torch, lattice, kernel, plain, tuned,
                                                    settings)
    assert max(common.values()) <= chip_smoke.DOUBLE_RTOL, common
    assert max(own.values()) <= chip_smoke.FIELD_RTOL, own
    assert small <= chip_smoke.K1_SMALL_RTOL


def test_backward_past_the_shared_memory_walks_segments(host_kernels):
    """fodo_lattice(90) with every quadrupole batched plans to 541 entries:
    past the 514 whose prefix products fit one setting's share of shared
    memory in double, which once cut such a tape into segments.  B4 keeps
    the state entering each entry in its device workspace instead, 541
    states a setting, against the plain version; B = 37 fills part of one
    64-setting block.  The chain of 541 maps grows cotangents to ~1e10 (the
    const cells', summed over the settings): 1e-11 of the largest is their
    rounding."""
    from lynx_tpu_torch.models.fodo import fodo_lattice

    B = 37
    rng = np.random.default_rng(8)
    lattice = fodo_lattice(90, dtype=torch.float64, device="cpu")
    for element in lattice.elements:
        if isinstance(element, ltt.Quadrupole):
            sign = 1.0 if float(element.k1) >= 0 else -1.0
            element.k1 = torch.from_numpy(sign * rng.uniform(0.5, 5.0, B))
    builders = [torch_fused.element_map_builder(el) for el in lattice.elements]
    energy = torch.full((B,), 1.073e8, dtype=torch.float64)
    plan = torch_fused.plan_run(builders, energy[:1], lambda x: torch.broadcast_to(x, (B,)))
    entries = tuple((kind, meta, len(values)) for kind, meta, values in plan)
    values = [v for _, _, vs in plan for v in vs]
    assert len(entries) == 541
    layout = fused_track._vjp_layout(entries, torch.device("cpu"), (True,) * len(values), True)
    assert layout.slots == 541 and layout.forward == 541
    mu = torch.from_numpy(
        np.concatenate([rng.normal(scale=1e-4, size=(B, 6)), np.ones((B, 1))], axis=1))
    a = rng.normal(scale=1e-4, size=(B, 7, 7))
    a[:, 6, :] = 0.0
    cov = torch.from_numpy(a @ np.swapaxes(a, 1, 2))
    check_backward(host_kernels, B, entries, values, energy, mu, cov,
                   torch.zeros(B, dtype=bool), rtol=1e-11)


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


# -- B8: the particle push with its maps built on the card --------------------


def push_plan(elements, B, dtype):
    """An all-dynamic plan of ``elements`` as B8 takes it: ``(entries,
    values, energy)`` with ``(B,)`` values and energy in ``dtype``."""
    builders = [torch_fused.element_map_builder(el) for el in elements]
    entries = tuple(("dyn", fn, len(params)) for params, fn in builders)
    values = [torch.broadcast_to(p, (B,)).to(dtype) for params, _ in builders for p in params]
    energy = torch.full((B,), 1.073e8, dtype=dtype) * torch.linspace(0.9, 1.1, B, dtype=dtype)
    return entries, values, energy


def run_push(host_kernels, entries, values, energy, particles):
    """B8 on the host: the ``(B, N, 7)`` particles pushed through the plan."""
    B, N, _ = particles.shape
    dtype = particles.dtype
    tape = fused_track._tape(entries, torch.device("cpu"))
    params, consts = fused_track._tape_operands(entries, values, tape, dtype, B)
    zeros, ones = fused_track._push_masks(entries)
    out = torch.empty_like(particles)
    code = host_kernels["particle_push"].lynx_particle_push(
        int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0],
        params.data_ptr(), consts.data_ptr(), energy.data_ptr(), particles.data_ptr(),
        out.data_ptr(), B, N, zeros, ones, REST_ENERGY_EV, ELECTRON_MASS_EV, None,
    )
    assert code == 0
    return out


def narrow_elements(B):
    """A run of the narrow kinds, float64: a quadrupole with per-setting
    tilt and misalignment and k1 = 0 on one setting, per-setting correctors
    and drift, a static tilted quadrupole, a marker and a screen."""
    rng = np.random.default_rng(11)
    k1 = np.linspace(-5.0, 5.0, B)
    k1[B // 2] = 0.0
    f64 = dict(dtype=torch.float64)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64))

    return [
        ltt.Marker(**f64, device="cpu"),
        ltt.Drift(t([0.5]), **f64),
        ltt.Quadrupole(t(np.full(B, 0.23)), k1=t(k1), tilt=t(rng.uniform(-0.2, 0.2, B)),
                       misalignment=t(rng.uniform(-2e-4, 2e-4, (B, 2))), **f64),
        ltt.HorizontalCorrector(t([0.1]), angle=t(rng.uniform(-1e-3, 1e-3, B)), **f64),
        ltt.VerticalCorrector(t([0.1]), angle=t(rng.uniform(-1e-3, 1e-3, B)), **f64),
        ltt.Quadrupole(t([0.2]), k1=t([3.0]), tilt=t([0.05]), **f64),
        ltt.Drift(t(rng.uniform(0.1, 0.6, B)), **f64),
        ltt.Screen(**f64, device="cpu"),
    ]


@pytest.mark.parametrize(
    "kind, B, N, dtype, shift",
    [
        ("narrow", 3, 700, torch.float64, 0),  # spans of 256: two whole, a ragged third
        ("narrow", 2, 300, torch.float64, 1),  # off 16 bytes: every span value by value
        ("narrow", 1, 1100, torch.float32, 0),  # float: spans of 512 as float4 vectors
        ("full", 4, 300, torch.float64, 0),  # the full instantiation's builders
        ("full", 2, 600, torch.float32, 0),
    ],
)
def test_particle_push_matches_plain(host_kernels, kind, B, N, dtype, shift):
    """B8 builds each setting's map from the tape in its block and pushes
    the setting's spans through it: against its plain version (the tables
    composed, then B2's plain push) over settings with their own fields and
    energies, spans that end inside a setting, tensors off the 16-byte
    alignment of its vectors, and both instantiations."""
    elements = narrow_elements(B) if kind == "narrow" else new_kind_elements(B)
    entries, values, energy = push_plan(elements, B, dtype)
    assert fused_track._tape(entries, torch.device("cpu")).full == (kind == "full")
    _, _, particles = push_inputs(B, N, dtype, shift)
    assert (particles.data_ptr() % 16 != 0) == bool(shift)
    out = run_push(host_kernels, entries, values, energy, particles)
    expected = fused_track.particle_push_reference(entries, values, energy, particles)
    assert per_setting_error(out, expected) <= (RTOL if dtype == torch.float64 else 1e-5)


def test_particle_push_skips_structural_zeros(host_kernels):
    """As B2: an infinite coordinate in a column that a row of the composed
    map does not use leaves that row finite, as in the plain version."""
    B, N = 2, 40
    entries, values, energy = push_plan(narrow_elements(B), B, torch.float64)
    _, _, particles = push_inputs(B, N, torch.float64)
    zeros, _ = fused_track._push_masks(entries)
    row, column = next((i, j) for j in range(7) for i in range(7) if zeros >> (7 * i + j) & 1)
    particles = particles.clone()
    particles[1, 7, column] = float("inf")
    out = run_push(host_kernels, entries, values, energy, particles)
    expected = fused_track.particle_push_reference(entries, values, energy, particles)
    finite = torch.isfinite(expected)
    assert bool(finite[1, 7, row]) and not bool(finite.all())
    assert torch.equal(torch.isfinite(out), finite)
    assert torch.equal(torch.isnan(out), torch.isnan(expected))
    zero = torch.zeros_like(out)
    kept = (torch.where(finite, out, zero), torch.where(finite, expected, zero))
    assert per_setting_error(*kept) <= RTOL


# -- B10: a run's maps folded per setting -------------------------------------------


def run_fold(host_kernels, entries, values, energy):
    """B10 on the host: the plan's composed non-literal cells, ``(n_cells,
    B)``, every setting at the ``(B,)`` energy."""
    B, dtype = energy.shape[0], energy.dtype
    tape = fused_track._tape(entries, torch.device("cpu"))
    params, consts = fused_track._tape_operands(entries, values, tape, dtype, B)
    _, cells = fused_track._fold_layout(entries)
    out = torch.full((bin(cells).count("1"), B), float("nan"), dtype=dtype)
    code = host_kernels["map_fold"].lynx_map_fold(
        int(dtype == torch.float64), int(tape.full), tape.rows.data_ptr(), tape.rows.shape[0],
        params.data_ptr(), consts.data_ptr(), energy.data_ptr(), out.data_ptr(), B, cells,
        REST_ENERGY_EV, ELECTRON_MASS_EV, None,
    )
    assert code == 0
    return out


def fold_error(entries, out, expected):
    """``chip_smoke.fold_error`` of B10's cells on the plan's composed layout:
    per setting and row, relative to the row's largest cell."""
    import chip_smoke

    return chip_smoke.fold_error(torch, fused_track._fold_layout(entries)[0], out, expected)


@pytest.mark.parametrize(
    "kind, B, dtype",
    [
        ("narrow", 3, torch.float64),
        ("narrow", 130, torch.float64),  # three blocks of 64 settings, the last ragged
        ("narrow", 5, torch.float32),
        ("full", 4, torch.float64),  # the full instantiation's builders
        ("full", 70, torch.float32),
    ],
)
def test_map_fold_matches_plain(host_kernels, kind, B, dtype):
    """B10 walks the tape for each setting in its own thread and writes the
    composed layout's non-literal cells, one row a cell: against its plain
    version (the tables composed, their cells stacked) over settings with
    their own fields and energies, blocks that end past the batch and both
    instantiations."""
    elements = narrow_elements(B) if kind == "narrow" else new_kind_elements(B)
    entries, values, energy = push_plan(elements, B, dtype)
    assert fused_track._tape(entries, torch.device("cpu")).full == (kind == "full")
    out = run_fold(host_kernels, entries, values, energy)
    expected = fused_track.map_fold_reference(entries, values, energy)
    assert out.shape == expected.shape
    assert fold_error(entries, out, expected) <= (RTOL if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("seed", range(16))
def test_map_fold_on_path_v_random_lattices(host_kernels, seed):
    """B10 on path V's random element mixes (``chip_smoke.random_lattice``,
    every field per setting, the cavities inactive), float64, against its
    plain version, and its cells at the layout the table route gives."""
    import chip_smoke

    B = 9
    lattice = chip_smoke.random_lattice(torch, ltt, seed, chip_smoke.random_length(seed),
                                        device="cpu")
    chip_smoke.apply_settings(lattice, chip_smoke.random_settings(torch, lattice, B, seed,
                                                                  cavities=False))
    entries, values, energy = push_plan(lattice.elements, B, torch.float64)
    out = run_fold(host_kernels, entries, values, energy)
    expected = fused_track.map_fold_reference(entries, values, energy)
    assert fold_error(entries, out, expected) <= RTOL
    total = fused_track._compose_entries(entries, values, energy)
    assert fused_track._split_table(total)[0] == fused_track._fold_layout(entries)[0]


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


def run_walk(host_kernels, entries, scalars, particles, weights, dtype=torch.float64):
    """B5 on the host, as its wrapper launches it: ``((s1, s2, w_sum),
    spans)`` in ``dtype``."""
    B, n = scalars[0].shape[0], particles.shape[0]
    is_double = int(dtype == torch.float64)
    library = host_kernels["particle_moment_sweep"]
    tape = fused_track._walk_tape(entries, torch.device("cpu"))
    literals = tape.literals.to(dtype)
    stacked = torch.stack(scalars).to(dtype).contiguous()
    cloud_t = particles.t().to(dtype).contiguous()
    weights = weights.to(dtype).contiguous()
    spans = library.lynx_particle_moment_spans(is_double, B, n)
    partials, arrived, out = fused_track._walk_workspace(B, spans, dtype, "cpu")
    code = library.lynx_particle_moment_sweep(
        is_double, tape.records.data_ptr(), tape.records.shape[0], literals.data_ptr(),
        stacked.data_ptr(), cloud_t.data_ptr(), weights.data_ptr(), partials.data_ptr(),
        arrived.data_ptr(), out.data_ptr(), B, n, spans, None,
    )
    assert code == 0
    assert arrived.tolist() == [spans] * B  # every block of each setting arrived once
    return fused_track._walk_sums(out), spans


def check_walk(host_kernels, B, n, dtype, spans):
    """B5 against the plain walk: two apertures (x_max = inf, an ellipse),
    0/1 weights; several blocks per setting, each reducing its 36 sums by
    warp shuffles and shared memory, the last to arrive adding the
    setting's partials.  Float against the plain walk in double on the same
    rounded inputs."""
    entries, scalars, particles, weights = moment_inputs(B, n)
    assert sum(e[0] == "aperture" for e in entries) == 4
    (s1, s2, w_sum), used = run_walk(host_kernels, entries, scalars, particles, weights, dtype)
    assert used == spans
    if dtype == torch.float32:
        scalars = tuple(s.float().double() for s in scalars)
        particles, weights = particles.float().double(), weights.float().double()
    expected = fused_track._moment_sweep_reference(entries, scalars, particles, weights)
    got = (s1.double(), s2.double(), w_sum.double())
    if n == 0:
        assert all(bool((t == 0).all()) for t in got)
        return
    assert 0 < float(expected[2].min()) < float(weights.sum())  # the apertures cut
    assert max(sums_errors(got, expected)) <= (RTOL if dtype == torch.float64 else 1e-5)


def test_particle_moment_sweep_matches_plain(host_kernels):
    check_walk(host_kernels, 13, 1001, torch.float64, 4)  # 4 spans of 256, the last of 233


@pytest.mark.parametrize(
    "B, n, dtype, spans",
    [
        (1, 1001, torch.float64, 4),  # one setting over four blocks
        (3, 1000, torch.float64, 4),  # double2 loads (n even), the last span of 232
        (2, 3000, torch.float32, 6),  # float4 loads: 6 spans of 512, the last of 440
        (5, 100, torch.float64, 1),  # fewer particles than one block's span
        (4, 0, torch.float64, 1),  # no particle: every sum is 0
    ],
)
def test_particle_moment_sweep_spans(host_kernels, B, n, dtype, spans):
    check_walk(host_kernels, B, n, dtype, spans)


def test_particle_moment_sweep_every_particle_lost(host_kernels):
    """Apertures closed to 1e-12 m on every setting: every weight is 0, and
    the sums are exact zeros, as in the plain walk."""
    B, n = 3, 700
    entries, scalars, particles, weights = moment_inputs(B, n)
    scalars = list(scalars)
    for entry in entries:
        if entry[0] == "aperture":
            scalars[entry[1]] = torch.full((B,), 1e-12, dtype=torch.float64)
    (s1, s2, w_sum), spans = run_walk(host_kernels, entries, tuple(scalars), particles, weights)
    assert spans == 3
    expected = fused_track._moment_sweep_reference(entries, tuple(scalars), particles, weights)
    assert float(expected[2].abs().max()) == 0
    for got, want in zip((s1, s2, w_sum), expected):
        assert torch.equal(got, want)


@pytest.mark.parametrize("is_double", [0, 1])
def test_walk_spans_fill_the_card(host_kernels, is_double):
    """B5's grid: spans of whole groups (128 threads x 4 floats or 2
    doubles), at least 132 blocks (one per SM) at every B of the route
    (1-15) at N = 100,000, and about 528 (four a multiprocessor) where
    the cloud allows; one span for a cloud of one group or none."""
    spans_of = host_kernels["particle_moment_sweep"].lynx_particle_moment_spans
    group = 128 * (2 if is_double else 4)
    for B in range(1, 16):
        spans = spans_of(is_double, B, 100_000)
        assert B * spans >= 132 and spans <= -(-100_000 // group)
        assert B * spans <= 528 + B
    assert spans_of(0, 8, 100_000) == 66  # path K: 528 blocks of 1,536 particles
    for n in (0, 1, group):
        assert spans_of(is_double, 8, n) == 1


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


def hist_indices(n, win, seed):
    """Indices in [-1, win + 4) on each axis: -1 pads and pairs past the
    window, which B7 drops."""
    rng = np.random.default_rng(seed)
    lx = torch.from_numpy(rng.integers(-1, win[0] + 4, n).astype(np.int32))
    ly = torch.from_numpy(rng.integers(-1, win[1] + 4, n).astype(np.int32))
    return lx, ly


def run_onehot(library, lx, ly, win, chunk):
    """B7's onehot read on the host, as its wrapper launches it."""
    n = lx.shape[0]
    out = torch.full((1, *win), 7, dtype=torch.int32)  # the read zeroes it
    workspace = torch.empty(library.lynx_hist_onehot_workspace(n, win[0], chunk),
                            dtype=torch.int32)
    code = library.lynx_hist_onehot(lx.data_ptr(), ly.data_ptr(), out.data_ptr(),
                                    workspace.data_ptr(), n, *win, chunk, None)
    assert code == 0
    return out


def one_bucket_and_gaps(n, seed):
    """Pairs in the (80, 300) window's row tiles 0, 2 and 4 only (empty
    buckets between full ones), half of them in tile 2, on all 300 columns
    (three 128-column slices, the last past the first 256 columns), with -1
    pads and pairs past the window."""
    rng = np.random.default_rng(seed)
    tile = rng.choice([0, 2, 2, 4], n)
    lx = tile * 16 + rng.integers(0, 16, n)
    ly = rng.integers(0, 300, n)
    lx[::17], ly[::23], ly[5::29] = -1, -1, 300 + rng.integers(0, 5, ly[5::29].shape)
    return torch.from_numpy(lx.astype(np.int32)), torch.from_numpy(ly.astype(np.int32))


@pytest.mark.parametrize(
    "chunk, n, win, layout",
    [
        (256, 3001, (16, 128), "uniform"),  # one bucket, 12 spans, the last ragged
        (1024, 700, (16, 128), "uniform"),  # one bucket, one span
        (64, 2500, (80, 300), "gaps"),  # empty buckets between full ones, three column slices
        (2048, 2500, (80, 300), "gaps"),  # a whole bucket a warp
        (96, 5000, (952, 256), "one tile"),  # every pair in one tile of the harness's window
        (256, 0, (40, 64), "uniform"),  # no pair: the read only zeroes the window
    ],
    ids=["256-3001", "1024-700", "64-2500-gaps", "2048-2500-gaps", "96-5000-one-tile", "256-0"],
)
def test_hist_onehot_equals_plain(host_kernels, chunk, n, win, layout):
    """B7's onehot read through the count, scatter and contraction kernels
    (the m16n8k32 s8, vcmpeq4 and byte_perm stand-ins): exactly the plain
    counts, the pairs outside the window dropped."""
    if layout == "gaps":
        lx, ly = one_bucket_and_gaps(n, seed=chunk)
    elif layout == "one tile":  # rows 480-495, the spot's centre
        rng = np.random.default_rng(9)
        lx = torch.from_numpy(rng.integers(480, 496, n).astype(np.int32))
        ly = torch.from_numpy(rng.integers(0, win[1], n).astype(np.int32))
    else:
        lx, ly = hist_indices(n, win, seed=chunk)
    library = host_kernels["hist_ab"]
    tiles, slices = -(-win[0] // 16), -(-win[1] // 128)
    assert library.lynx_hist_onehot_warps(n, *win, chunk) == (-(-n // chunk) + tiles) * slices
    out = run_onehot(library, lx, ly, win, chunk)
    expected = hist_ab.hist_ab_reference(lx, ly, *win)
    assert torch.equal(out, expected)
    if n:
        assert 0 < int(out.sum()) <= n
    if layout == "gaps":
        rows = expected[0].sum(dim=1)
        assert int(rows[16:32].sum()) == 0 and int(rows[32:48].sum()) > n // 3
    workspace = torch.empty(library.lynx_hist_onehot_workspace(n, win[0], 32), dtype=torch.int32)
    for bad in (100, 0, 65568):  # not a multiple of 32, or out of range
        assert library.lynx_hist_onehot(lx.data_ptr(), ly.data_ptr(), out.data_ptr(),
                                        workspace.data_ptr(), n, *win, bad, None) != 0


TWOLEVEL = [name for name in hist_ab.VARIANTS if name.startswith("twolevel")]


def run_twolevel(library, lx, ly, win, cluster, splits):
    out = torch.full((1, *win), 7, dtype=torch.int32)  # written whole, or zeroed first
    code = library.lynx_hist_twolevel(lx.data_ptr(), ly.data_ptr(), out.data_ptr(), lx.shape[0],
                                      *win, cluster, splits, None)
    assert code == 0
    return out


@pytest.mark.parametrize("name", TWOLEVEL)
@pytest.mark.parametrize("layout", ["uniform", "one block"])
def test_hist_twolevel_equals_plain(host_kernels, name, layout):
    """B7's window in a cluster's distributed shared memory, at each of the
    A/B's (C, K): exactly the plain counts, the pairs outside the window
    dropped.  "uniform": pads and pairs past the window over a (40, 128)
    window (C = 16 leaves blocks of 2 and 3 rows); "one block": every pair
    in rows x = 5 mod C, so one block of the cluster takes every atomic."""
    _, knob = hist_ab.VARIANTS[name]
    cluster, splits = knob["cluster"], knob["splits"]
    win, n = (40, 128), 3001  # n not a multiple of 4: the scalar tail
    if layout == "uniform":
        lx, ly = hist_indices(n, win, seed=cluster + splits)
    else:
        rng = np.random.default_rng(cluster * splits)
        rows = np.arange(5, win[0], cluster)
        lx = torch.from_numpy(rng.choice(rows, n).astype(np.int32))
        ly = torch.from_numpy(rng.integers(0, win[1], n).astype(np.int32))
    out = run_twolevel(host_kernels["hist_ab"], lx, ly, win, cluster, splits)
    expected = hist_ab.hist_ab_reference(lx, ly, *win)
    assert torch.equal(out, expected)
    if layout == "one block":
        assert int(out.sum()) == n and int(expected[0, 5::cluster].sum()) == n


def test_hist_twolevel_scalar_paths_and_refusals(host_kernels):
    """Pairs off 16 bytes (the scalar loads), a window whose rows are not a
    multiple of 4 (the scalar stores), no pair at all; and the refusals: a
    cluster past 16, rows past a block's shared memory."""
    library = host_kernels["hist_ab"]
    lx, ly = hist_indices(2001, (20, 30), seed=3)
    for cluster, splits in ((8, 1), (16, 2)):
        out = run_twolevel(library, lx[1:], ly[1:], (20, 30), cluster, splits)
        assert torch.equal(out, hist_ab.hist_ab_reference(lx[1:], ly[1:], 20, 30))
        empty = run_twolevel(library, lx[:0], ly[:0], (20, 30), cluster, splits)
        assert int(empty.abs().sum()) == 0
    out = torch.zeros((1, 20, 30), dtype=torch.int32)
    for cluster, splits, win in ((17, 1, (20, 30)), (8, 0, (20, 30)), (1, 1, (64, 1024))):
        assert library.lynx_hist_twolevel(lx.data_ptr(), ly.data_ptr(), out.data_ptr(), 10, *win,
                                          cluster, splits, None) != 0
    assert library.lynx_hist_twolevel_max_clusters(952, 256, 16) > 0
    assert library.lynx_hist_twolevel_max_clusters(952, 256, 1) < 0  # 975 KB in one block


# -- kernel B1: the fused windowed read ------------------------------------------

READ_BINS = (60, 200)
READ_RANGES = (-3e-3, 3e-3, -5e-3, 5e-3)


def read_spot(B, n, dtype, seed, sigma=(3.0, 8.0), centre=((30.0, 100.0),)):
    """B rows of a Gaussian spot (sigma and centre in bins) over the
    READ_BINS image, each row's centre moved, with dead particles (weight
    0) and a few out of range."""
    rng = np.random.default_rng(seed)
    lo_x, hi_x, lo_y, hi_y = READ_RANGES
    px, py = (hi_x - lo_x) / READ_BINS[0], (hi_y - lo_y) / READ_BINS[1]
    cx = centre[0][0] + 5.0 * np.arange(B)[:, None]
    cy = centre[0][1] - 20.0 * np.arange(B)[:, None]
    x = lo_x + px * (cx + sigma[0] * rng.normal(size=(B, n)))
    y = lo_y + py * (cy + sigma[1] * rng.normal(size=(B, n)))
    x[:, :3] = hi_x * 1.5  # out of range
    w = rng.uniform(0.5, 1.5, (B, n)) * (rng.uniform(size=(B, n)) > 0.1)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype),
            torch.from_numpy(w).to(torch.float32))


def read_ranges(kind, dtype, B):
    if kind == "floats":
        return READ_RANGES
    if kind == "rows":  # one bound a row, shaped to broadcast as _bin_index takes it
        return tuple(torch.full((B, 1), v, dtype=dtype) for v in READ_RANGES)
    return tuple(torch.tensor(v, dtype=dtype) for v in READ_RANGES)


def host_read(library, x, y, w, ranges, bins, window, binary):
    """B1's fused read on the host, marshalled as the wrapper marshals it;
    tensor bounds (on the CPU, as x is) are read from (host) device memory."""
    code, image, ox, oy, misfit = torch_hist._read_launch(
        library, x, y, w, ranges, bins, window, binary, None)
    assert code == 0
    return image, ox, oy, ~misfit


def check_read(library, x, y, w, ranges, bins, window, binary, rtol=1e-5):
    window = torch_hist._window_shape(window, *bins)
    image, ox, oy, fits = host_read(library, x, y, w, ranges, bins, window, binary)
    ref_image, ref_ox, ref_oy, ref_fits = torch_hist.windowed_read_reference(
        x, y, w, ranges, bins, window, binary)
    assert torch.equal(ox, ref_ox) and torch.equal(oy, ref_oy)
    assert torch.equal(fits, ref_fits)
    assert image.shape == ref_image.shape and image.dtype == ref_image.dtype
    if binary:
        assert torch.equal(image, ref_image)
    else:  # float atomics sum in any order: 1e-5 relative, per cell
        torch.testing.assert_close(image, ref_image, rtol=rtol, atol=0.0)
    return image, fits


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("binary", [True, False], ids=["count", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_windowed_read_equals_plain(host_kernels, B, binary, dtype):
    """B1's fused read against the plain version: origins and fits equal,
    the image exact in count mode; each row with its own origin, x a
    strided view as the screen passes it."""
    x, y, w = read_spot(B, 2001, dtype, seed=B)
    particles = torch.stack([x, torch.zeros_like(x), y], dim=-1)  # x, y with stride 3
    x, y = particles[..., 0], particles[..., 2]
    image, fits = check_read(host_kernels["window_histogram"], x, y, w,
                             read_ranges("0-d", dtype, B), READ_BINS, (32, 128), binary)
    assert bool(fits.all())
    if binary:
        live = int((w != 0).sum()) - int((w[:, :3] != 0).sum())
        assert int(image.sum()) == live


def reciprocal_bins(v, lo, hi, n):
    """Bins as the kernel forms them from a span on the host: PyTorch's CUDA
    division by a CPU scalar, the product by the reciprocal rounded in v's
    dtype."""
    inv = 1.0 / torch.tensor(hi - lo, dtype=v.dtype)
    return torch.clamp(torch.floor((v - lo) * inv * n), 0, n - 1).to(torch.int32)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["floats", "rows"])
def test_windowed_read_takes_every_kind_of_range(host_kernels, kind, B):
    """Ranges as Python floats (the span and its reciprocal on the host)
    and one bound a row, in float32.  With Python floats the kernel takes
    the reciprocal product, as PyTorch's CUDA division by a CPU scalar
    does, while the CPU plain version divides: the comparison is exact only
    while no particle bins differently under the two, which is asserted
    first (chip_smoke.py holds both on the card, where both take the
    product)."""
    x, y, w = read_spot(B, 1500, torch.float32, seed=B)
    if kind == "floats":
        lo_x, hi_x, lo_y, hi_y = READ_RANGES
        for v, lo, hi, n in ((x, lo_x, hi_x, READ_BINS[0]), (y, lo_y, hi_y, READ_BINS[1])):
            assert torch.equal(reciprocal_bins(v, lo, hi, n), torch_hist._bin_index(v, lo, hi, n)[0])
    check_read(host_kernels["window_histogram"], x, y, w, read_ranges(kind, torch.float32, B),
               READ_BINS, (32, 128), True)


def edge_particles(dtype):
    """Row 0: particles on a grid of interior bin edges (formed in the
    compute type, so they sit where the arithmetic puts an edge), exactly
    on lo and hi in x, one ulp past hi, at +-inf and NaN, one of weight 0;
    row 1: only dead particles (x NaN)."""
    lo_x, hi_x, lo_y, hi_y = (torch.tensor(v, dtype=dtype) for v in READ_RANGES)
    nx, ny = READ_BINS
    ex = lo_x + (hi_x - lo_x) / nx * torch.arange(20, 37, dtype=dtype)
    ey = lo_y + (hi_y - lo_y) / ny * torch.arange(90, 107, dtype=dtype)
    gx, gy = torch.meshgrid(ex, ey, indexing="ij")
    inf, nan = float("inf"), float("nan")
    extra_x = torch.stack([lo_x, hi_x, torch.nextafter(hi_x, hi_x + 1), ex[2], ex[2], ex[2],
                           torch.tensor(nan, dtype=dtype), torch.tensor(inf, dtype=dtype),
                           torch.tensor(-inf, dtype=dtype), ex[4]])
    extra_y = torch.stack([ey[0], ey[5], ey[5], torch.tensor(nan, dtype=dtype),
                           torch.tensor(inf, dtype=dtype), torch.tensor(-inf, dtype=dtype),
                           ey[1], ey[1], ey[1], ey[3]])
    x0 = torch.cat([gx.reshape(-1), extra_x])
    y0 = torch.cat([gy.reshape(-1), extra_y])
    n = x0.numel()
    x = torch.stack([x0, torch.full((n,), nan, dtype=dtype)])
    y = torch.stack([y0, y0])
    w = torch.ones((2, n), dtype=torch.float32)
    w[0, -1] = 0.0
    return x, y, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_windowed_read_bin_edges_nan_and_dead_rows(host_kernels, dtype):
    """Bins bit for bit on the edges, lo and hi counted, NaN and +-inf
    never live, an all-dead row at the clamped origin with an empty
    window; count mode, exact."""
    x, y, w = edge_particles(dtype)
    image, fits = check_read(host_kernels["window_histogram"], x, y, w,
                             read_ranges("0-d", dtype, 2), READ_BINS, (64, 128), True)
    assert int(image[1].sum()) == 0 and bool(fits.all())
    assert int(image[0].sum()) == 17 * 17 + 2  # the grid, lo and hi


@pytest.mark.parametrize("binary", [True, False], ids=["count", "weighted"])
def test_windowed_read_misfit_and_window_past_the_edge(host_kernels, binary):
    """A spot wider than its window (that row's fits False, the image the
    plain version's window-only image, the other row fitting), and a
    rounded window past the image's edge in y (origin 0 there, cropped)."""
    wide, narrow = (read_spot(2, 2000, torch.float32, seed=5, sigma=(sx, 8.0))
                    for sx in (12.0, 1.5))
    x, y, w = (torch.cat([a[:1], b[1:]]) for a, b in zip(wide, narrow))
    _, fits = check_read(host_kernels["window_histogram"], x, y, w,
                         read_ranges("0-d", torch.float32, 2), READ_BINS, (16, 128), binary)
    assert fits.tolist() == [False, True]
    bins = (READ_BINS[0], 100)  # the window's 128 columns pass 100
    check_read(host_kernels["window_histogram"], x, y, w, read_ranges("0-d", torch.float32, 2),
               bins, (40, 100), binary)


def test_windowed_read_weighted_double_and_refusals(host_kernels):
    """float64 weights sum in float64; the entry point refuses an empty
    read, bins past the packed 15 bits and a batch past the grid's 65,535
    rows, and the wrapper bins past 32,767 before any launch."""
    library = host_kernels["window_histogram"]
    x, y, w = read_spot(2, 1500, torch.float64, seed=8)
    check_read(library, x, y, w.double(), read_ranges("0-d", torch.float64, 2), READ_BINS,
               (32, 128), False, rtol=1e-12)
    window = torch_hist._window_shape((32, 128), *READ_BINS)
    for rows, n, bins in ((1, 0, READ_BINS), (1, 10, (40_000, 10)), (65_536, 1, READ_BINS)):
        code = host_read_code(library, rows, n, bins, window)
        assert code == 1  # cudaErrorInvalidValue
    with pytest.raises(ValueError, match="bins"):
        torch_hist._read_launch(library, x, y, w, read_ranges("0-d", torch.float64, 2),
                                (40_000, 10), window, True, None)



@pytest.mark.parametrize("binary", [True, False], ids=["count", "weighted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_windowed_read_completion_equals_the_scatter(host_kernels, binary, dtype):
    """B1's completion (the third launch) against its plain version: where
    rows misfit (one in x, one in y, one fits), the image becomes the scatter's for the whole
    batch (count mode exactly, weighted within the float atomics' order) and
    the device counter counts the read once; where every row fits, the
    read's image stays and the counter does not move."""
    library = host_kernels["window_histogram"]
    window = torch_hist._window_shape((16, 128), *READ_BINS)
    ranges = read_ranges("0-d", dtype, 3)
    wide_x = read_spot(3, 1500, dtype, seed=11, sigma=(12.0, 8.0))
    wide_y = read_spot(3, 1500, dtype, seed=13, sigma=(1.5, 60.0))
    narrow = read_spot(3, 1500, dtype, seed=12, sigma=(1.5, 8.0))
    mixed = tuple(torch.cat([a[:1], b[1:2], c[2:]]) for a, b, c in zip(wide_x, wide_y, narrow))
    counter = torch.zeros((), dtype=torch.int32)
    for (x, y, w), fell in ((mixed, 1), (narrow, 0)):
        w = (w != 0).to(dtype) if binary else w.to(dtype)  # count mode's promise: 0/1 weights
        before = int(counter)
        code, image, _, _, misfit = torch_hist._read_launch(
            library, x, y, w, ranges, READ_BINS, window, binary, None, counter)
        assert code == 0 and bool(misfit.any()) == bool(fell)
        ref_image, _, _, fits = torch_hist.windowed_read_reference(x, y, w, ranges, READ_BINS,
                                                                   window, binary)
        expected = torch_hist.complete_read_reference(x, y, w, ranges, READ_BINS, ref_image, fits)
        assert int(counter) == before + fell
        if binary:
            assert torch.equal(image, expected)
        else:
            torch.testing.assert_close(image, expected, rtol=1e-5 if dtype == torch.float32
                                       else 1e-12, atol=0.0)
        if fell:
            scatter = torch_hist.weighted_histogram_2d(x, y, w, ranges[:2], ranges[2:], READ_BINS)
            assert torch.equal(expected, scatter)

def host_read_code(library, rows, n, bins, window):
    """The entry point's code for a read of ``rows`` x ``n`` particles into
    ``bins``, marshalled by hand (no buffers: a refused read reads none)."""
    strides = (ctypes.c_longlong * 6)(n, 1, n, 1, n, 1)
    pointers = (ctypes.c_void_p * 4)()
    steps = (ctypes.c_longlong * 4)()
    values = (ctypes.c_double * 6)(0.0, 1.0, 1.0, 0.0, 1.0, 1.0)
    divide = (ctypes.c_int * 2)()
    return library.lynx_windowed_read(None, None, None, strides, pointers, steps, values, divide,
                                      None, None, None, rows, n, *bins, *window, 0, 0, 0, None)
