"""The kernel build-and-load path (``lynx_tpu_torch._build``) on the CPU.

There is no nvcc here, so a stand-in ``nvcc`` compiles a C stub with the
same entry points using gcc.  What is checked is the host side: the build
into a hashed directory, and the ctypes signatures declared at load (an
undeclared pointer argument would be cut to 32 bits)."""

import os
import shutil
import stat
import sys

import pytest
import torch

from lynx_tpu_torch import _build
from lynx_tpu_torch.ops import histogram as hist

STUB = r"""
#include <stdint.h>
int lynx_window_histogram(const void* lx, const void* ly, const void* w, void* out,
                          long long batch, long long n, int win_x, int win_y, void* stream) {
  int32_t* o = (int32_t*)out;
  o[0] = ((const int32_t*)lx)[0]; o[1] = ((const int32_t*)ly)[1];
  o[2] = (int32_t)batch; o[3] = (int32_t)n; o[4] = win_x; o[5] = win_y;
  o[6] = w == 0; o[7] = stream == 0;
  return 0;
}
int lynx_windowed_read(void) { return 1; }
int lynx_windowed_read_complete(void) { return 1; }
const char* lynx_cuda_error_string(int code) { return "stub error"; }
"""

FAKE_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
sys.exit(subprocess.call(["gcc", "-shared", "-fPIC", "-O2", "-x", "c", "-o", out, "{stub}"]))
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    assert shutil.which("gcc"), "the build-path test needs gcc"
    stub = tmp_path / "stub.c"
    stub.write_text(STUB)
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, stub=stub))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "window_histogram.cu").write_text("// stand-in source\n")
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    return tmp_path


def test_library_builds_once_into_a_hashed_directory(fake_toolchain):
    library = hist.window_histogram_library()
    built = list((fake_toolchain / "build").glob("window_histogram-*/libwindow_histogram.so"))
    assert len(built) == 1
    assert hist.window_histogram_library() is library  # loaded once per process


def test_entry_point_receives_full_width_arguments(fake_toolchain):
    library = hist.window_histogram_library()
    lx = torch.full((3, 5), 77, dtype=torch.int32)
    ly = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    out = torch.zeros(8, dtype=torch.int32)
    code = library.lynx_window_histogram(
        lx.data_ptr(), ly.data_ptr(), None, out.data_ptr(), 3, 5, 952, 256, 0
    )
    assert code == 0
    assert out.tolist() == [77, 1, 3, 5, 952, 256, 1, 1]


def test_check_raises_with_the_cuda_message(fake_toolchain):
    library = hist.window_histogram_library()
    _build.check(library, 0, "window_histogram")
    with pytest.raises(RuntimeError, match="CUDA error 2 \\(stub error\\)"):
        _build.check(library, 2, "window_histogram")


def test_kernel_variants_edit_the_tree_sources():
    """``tools/kernel_variants.py`` times edits of the kernels' sources: each
    variant's text is in its kernel's source exactly once, so that each
    builds the edit it names."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    assert variants.VARIANTS
    for name, (library, old, new, _) in variants.VARIANTS.items():
        text = variants.edited_source(name)
        assert new in text and old not in text, name
        assert text.replace(new, old) == (_build.CSRC / f"{library}.cu").read_text()
