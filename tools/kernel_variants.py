#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels beside the tree's, on one GPU.

    python3 tools/kernel_variants.py [VARIANT ...]

A variant is one edit of a kernel's source: the script writes the edited
copy (with the shared ``csrc/*.cuh`` headers) under
``build/variants/<variant>/``, builds it with ``nvcc`` and the package's
flags, prints its ptxas registers and spill bytes, loads it in the place of
the tree's library (the wrappers then launch it), holds it against its plain
version with ``chip_smoke.py``'s checks, and times it with
``chip_smoke.py``'s timers at the paths' shapes.  The tree's own kernels run
first, so that every number of a call is compared within the call.  With no
argument every variant in ``VARIANTS`` runs.  It needs a CUDA device and
imports neither JAX nor ``lynx_tpu``.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

#: name -> (kernel library, text of its .cu to replace, replacement, what it is).
VARIANTS = {
    "B6-fma": (
        "packed_gram",
        "constexpr bool kTensorCores = std::is_same<T, float>::value;",
        "constexpr bool kTensorCores = false;",
        "B6's float Gram as FP32 FMAs of the mask with q, one thread per setting",
    ),
    "B6-chunk256": (
        "packed_gram",
        "constexpr int kChunk = 128;",
        "constexpr int kChunk = 256;",
        "B6 staging 256 particles a chunk",
    ),
    "B3-96": (
        "moment_sweep",
        "__launch_bounds__(kSettings) moment_sweep_kernel",
        "__launch_bounds__(kSettings, 10) moment_sweep_kernel",
        "B3 held to 96 registers (10 blocks of 64 a multiprocessor)",
    ),
    "B3-80": (
        "moment_sweep",
        "__launch_bounds__(kSettings) moment_sweep_kernel",
        "__launch_bounds__(kSettings, 12) moment_sweep_kernel",
        "B3 held to 80 registers (12 blocks of 64 a multiprocessor)",
    ),
    "B5-8-blocks": (
        "particle_moment_sweep",
        "constexpr int64_t kTargetBlocks = 132 * 4;",
        "constexpr int64_t kTargetBlocks = 132 * 8;",
        "B5 aiming at eight blocks a multiprocessor: shorter spans, more partials",
    ),
    "B5-256-threads": (
        "particle_moment_sweep",
        "constexpr int kThreads = 128;",
        "constexpr int kThreads = 256;",
        "B5 in blocks of 256 threads (spans of whole 256-thread groups)",
    ),
    "B7-no-prefetch": (
        "hist_ab",
        "    int4 u = u_next, v = v_next;\n"
        "    if (s + 32 < to) u_next = lane_pairs[8], v_next = lane_pairs[12];",
        "    int4 u = lane_pairs[0], v = lane_pairs[4];",
        "B7's onehot contraction loading each step's pairs when it starts",
    ),
    "B7-512-threads": (
        "hist_ab",
        "constexpr int kClusterThreads = 1024;",
        "constexpr int kClusterThreads = 512;",
        "B7's twolevel cluster blocks of 512 threads",
    ),
    "B7-256-threads": (
        "hist_ab",
        "constexpr int kClusterThreads = 1024;",
        "constexpr int kClusterThreads = 256;",
        "B7's twolevel cluster blocks of 256 threads",
    ),
    "B4-inline-pass": (
        "moment_sweep_bwd",
        """          T p[kP];
          entry_params<kFull>(entry, params, batch, b, p);
          for (int pass = 0; pass < kPasses; ++pass) {
            if (pass > 0 && pass * kLanes > n) break;
            dual_pass<kFull>(entry, p, pass * kLanes, n, M, S1, slot, d_params, batch, b, active,
                             e_b, rest, mass, lane);
          }""",
        """          T p[kP];
          entry_params<kFull>(entry, params, batch, b, p);
          for (int pass = 0; pass < kPasses; ++pass) {
            const int base = pass * kLanes;
            if (pass > 0 && base > n) break;
            const int q = base + lane;
            lynx::Dual<T> pd[kP];
#pragma unroll
            for (int k = 0; k < kP; ++k) pd[k] = lynx::Dual<T>(p[k], k == q ? T(1) : T(0));
            const lynx::Dual<T> ed(e_b, q == n ? T(1) : T(0));
            lynx::Dual<T> Rd[49];
            lynx::build_dynamic<kFull, T, lynx::Dual<T>>(entry.kind, pd, ed, rest, mass, Rd);
            T g = T(0);
#pragma unroll
            for (int i = 0; i < 7; ++i) {
              T dri[7];
              load_row(M + i * kRow, dri);
#pragma unroll
              for (int k = 0; k < 7; ++k) g = g + dri[k] * Rd[i * 7 + k].d;
            }
            if (q < n) {
              if (active) d_params[(entry.offset + q) * batch + b] = g;
            } else if (q == n) {
              *slot = g;
            }
            if (!kFull || base + kLanes > n) scatter_rows(Rd, S1, lane);
          }""",
        "B4's dual passes written inline in the kernel, as before the pass function",
    ),
}


def edited_source(name):
    """The variant's kernel source: the tree's with its one edit."""
    library, old, new, _ = VARIANTS[name]
    from lynx_tpu_torch import _build

    text = (_build.CSRC / f"{library}.cu").read_text()
    if text.count(old) != 1:
        raise ValueError(f"variant {name}: {old!r} is not in {library}.cu exactly once")
    return text.replace(old, new)


def build_variants(names, signatures):
    """Build the variants (one nvcc each, all at once) and load them:
    ``{name: (library name, ctypes library)}``."""
    from lynx_tpu_torch import _build

    running = []
    for name in names:
        library = VARIANTS[name][0]
        directory = ROOT / "build" / "variants" / name
        shutil.rmtree(directory, ignore_errors=True)
        directory.mkdir(parents=True)
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, directory / header.name)
        source = directory / f"{library}.cu"
        source.write_text(edited_source(name))
        target = directory / f"lib{library}.so"
        command = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target), str(source)]
        process = subprocess.Popen(command, stderr=subprocess.PIPE, text=True)
        running.append((name, library, target, process))
    loaded = {}
    for name, library, target, process in running:
        _, log = process.communicate()
        if process.returncode != 0:
            raise RuntimeError(f"nvcc failed to build variant {name}:\n{log}")
        print(f"variant {name} ({VARIANTS[name][3]}): ptxas: {chip_smoke.ptxas_report(log)}")
        handle = ctypes.CDLL(str(target))
        functions = {"lynx_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
                     **signatures[library]}
        for function, (restype, argtypes) in functions.items():
            getattr(handle, function).restype = restype
            getattr(handle, function).argtypes = argtypes
        loaded[name] = (library, handle)
    return loaded


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: torch.cuda.is_available() is False; this needs one GPU")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [name for name in names if name not in VARIANTS]
    if unknown:
        raise SystemExit(f"kernel_variants: no variant {unknown}; known: {list(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)

    import lynx_tpu_torch as ltt
    from lynx_tpu_torch import ParticleBeam, _build, envs
    from lynx_tpu_torch.accelerator import fused
    from lynx_tpu_torch.benchmarks import hist_ab
    from lynx_tpu_torch.ops import fused_track as ft
    from lynx_tpu_torch.ops import histogram as hist
    from lynx_tpu_torch.ops import table as tbl

    _build.build_libraries(chip_smoke.KERNEL_LIBRARIES)
    for name, (_, log) in _build.BUILD_LOG.items():
        print(f"tree {name}: ptxas: {chip_smoke.ptxas_report(log)}")
    tree = {"hist_ab": hist_ab.hist_ab_library(),
            "moment_sweep": ft.moment_sweep_library(),
            "moment_sweep_bwd": ft.moment_sweep_bwd_library(),
            "particle_moment_sweep": ft.particle_moment_sweep_library(),
            "packed_gram": ft.packed_gram_library()}
    variants = build_variants(names, {"hist_ab": hist_ab._B7_SIGNATURE,
                                      "moment_sweep": ft._B3_SIGNATURE,
                                      "moment_sweep_bwd": ft._B4_SIGNATURE,
                                      "particle_moment_sweep": ft._B5_SIGNATURE,
                                      "packed_gram": ft._B6_SIGNATURE})
    env = envs.make_env(device="cuda")
    runs = [("tree", library, tree[library]) for library in sorted({VARIANTS[n][0] for n in names})]
    runs += [(name, library, handle) for name, (library, handle) in variants.items()]
    for label, library, handle in runs:
        _build._LIBRARIES.update(tree)
        _build._LIBRARIES[library] = handle
        print(f"=== {label}: {library}")
        if library in ("moment_sweep", "moment_sweep_bwd"):
            chip_smoke.check_sweep_kernels(torch, ltt, ft, fused, env)
            chip_smoke.time_kernels(torch, ft, fused, tbl, env, card)
        elif library == "hist_ab":
            chip_smoke.path_hist_ab(torch, hist, card)
        else:
            chip_smoke.check_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam)
            chip_smoke.time_moment_kernels(torch, ltt, ft, fused, env, ParticleBeam, card)
    _build._LIBRARIES.update(tree)


if __name__ == "__main__":
    main()
