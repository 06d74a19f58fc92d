"""The PyTorch port and its chip smoke run never import JAX: the GPU
machine has none."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run(code):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )


def test_port_imports_no_jax():
    result = run(
        "import sys, torch\n"
        "import lynx_tpu_torch, lynx_tpu_torch.models, lynx_tpu_torch.converters\n"
        "import chip_smoke\n"
        "from lynx_tpu_torch.models import ares_ea_segment\n"
        "segment = ares_ea_segment()\n"
        "segment.AREABSCR1.is_active = True\n"
        "beam = lynx_tpu_torch.ParticleBeam.from_parameters(num_particles=100)\n"
        "lynx_tpu_torch.functional.track(segment, beam)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'lynx_tpu' not in sys.modules\n"
    )
    assert result.returncode == 0, result.stderr


def test_chip_smoke_fails_without_a_gpu():
    """Without CUDA the smoke run exits non-zero and prints no result line."""
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
