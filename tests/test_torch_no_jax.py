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
        "import lynx_tpu_torch.benchmarks.hist_ab, lynx_tpu_torch.models.fodo\n"
        "import lynx_tpu_torch.checkpoint, lynx_tpu_torch.log, lynx_tpu_torch.random\n"
        "import lynx_tpu_torch.track_methods\n"
        "import lynx_tpu_torch.metrics, lynx_tpu_torch.debug, lynx_tpu_torch.profiling\n"
        "from lynx_tpu_torch.examples import emittance_measurement, gradient_tuning\n"
        "from lynx_tpu_torch.examples import image_tuning, particle_fidelity_sweep\n"
        "from lynx_tpu_torch.examples import ppo_ares_ea, simple\n"
        "from lynx_tpu_torch.examples import multichip_tuning, optimize_speed\n"
        "import lynx_tpu_torch.parallel, lynx_tpu_torch.benchmarks.layer_cost\n"
        "from lynx_tpu_torch.converters import astra, bmad, nxtables, ocelot, ocelot_shim\n"
        "import chip_smoke\n"
        "from lynx_tpu_torch.models import ares_lattice\n"
        "lattice = ares_lattice(device='cpu')\n"
        "assert len({type(e).__name__ for e in lattice.elements}) == 11\n"
        "from lynx_tpu_torch.models import ares_ea_segment\n"
        "segment = ares_ea_segment(device='cpu')\n"
        "segment.AREABSCR1.is_active = True\n"
        "beam = lynx_tpu_torch.ParticleBeam.from_parameters(num_particles=100, device='cpu')\n"
        "lynx_tpu_torch.functional.track(segment, beam)\n"
        "r = 'tests/resources/'\n"
        "nx = lynx_tpu_torch.Segment.from_nx_tables(r + 'nxtables_ares_stage4.csv', device='cpu')\n"
        "assert len(nx.elements) == 235\n"
        "assert len(lynx_tpu_torch.Segment.from_bmad(r + 'bmad_tutorial_lattice.bmad',\n"
        "                                            device='cpu').elements) == 3\n"
        "cell = [ocelot_shim.Quadrupole(l=0.2, k1=4.2, eid='q'), ocelot_shim.Drift(l=0.5, eid='d')]\n"
        "assert len(lynx_tpu_torch.Segment.from_ocelot(cell, device='cpu').elements) == 2\n"
        "assert astra.from_astrabeam(r + 'ACHIP_EA1_2021.1351.001')[0].shape == (100000, 6)\n"
        "import tempfile, os\n"
        "path = os.path.join(tempfile.mkdtemp(), 'lattice.json')\n"
        "lattice.to_lattice_json(path)\n"
        "assert lynx_tpu_torch.Segment.from_lattice_json(path, device='cpu') == lattice\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'lynx_tpu' not in sys.modules\n"
    )
    assert result.returncode == 0, result.stderr


def test_port_and_chip_smoke_import_no_gymnasium_or_matplotlib():
    """The GPU machine has neither: the Gym adapter and the plots import
    them only when used."""
    result = run(
        "import sys\n"
        "import lynx_tpu_torch, lynx_tpu_torch.envs, lynx_tpu_torch.profiling\n"
        "import lynx_tpu_torch.debug, lynx_tpu_torch.metrics, lynx_tpu_torch.examples\n"
        "import chip_smoke\n"
        "for name in ('gymnasium', 'matplotlib'):\n"
        "    assert name not in sys.modules, name\n"
    )
    assert result.returncode == 0, result.stderr


def test_chip_smoke_fails_without_a_gpu():
    """Without CUDA the smoke run exits non-zero and prints no result line."""
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_port_and_chip_smoke_name_no_file_under_the_jax_package():
    """No string in the port's modules or ``chip_smoke.py`` names a path
    under ``lynx_tpu/``: a bare ``"lynx_tpu"`` path component, or a
    ``lynx_tpu/...`` path other than a ``file.py:line`` reference to the
    TPU kernel a CUDA kernel replaces."""
    import re
    import tokenize

    reference = re.compile(r"lynx_tpu/[\w/]+\.py:\d+")
    found = []
    for path in sorted((REPO / "lynx_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        with open(path, "rb") as source:
            for token in tokenize.tokenize(source.readline):
                if token.type != tokenize.STRING:
                    continue
                text = token.string.strip("'\"")
                if text == "lynx_tpu" or "lynx_tpu/" in reference.sub("", token.string):
                    found.append(f"{path.relative_to(REPO)}:{token.start[0]}")
    assert not found, found


def test_port_opens_no_file_under_the_jax_package():
    """Loading the lattices, the models and a LatticeJSON round trip opens
    no file under ``lynx_tpu/`` (an audit hook sees every ``open``)."""
    result = run(
        "import sys, os\n"
        f"jax_tree = os.path.join({str(REPO)!r}, 'lynx_tpu') + os.sep\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes, os.PathLike)):\n"
        "        path = os.path.abspath(os.fsdecode(args[0]))\n"
        "        if path.startswith(jax_tree):\n"
        "            opened.append(path)\n"
        "sys.addaudithook(hook)\n"
        "import lynx_tpu_torch\n"
        "from lynx_tpu_torch.models import ares_ea_segment, ares_lattice, fodo_lattice\n"
        "lattice = ares_lattice(device='cpu')\n"
        "ares_ea_segment(device='cpu')\n"
        "fodo_lattice(num_cells=2, device='cpu')\n"
        "assert not opened, opened\n"
    )
    assert result.returncode == 0, result.stderr


def test_ares_lattice_loads_without_the_jax_package(tmp_path):
    """A copy of ``lynx_tpu_torch`` alone, with ``lynx_tpu`` made
    unimportable, loads the full ARES lattice and its EA subcell."""
    import shutil

    shutil.copytree(REPO / "lynx_tpu_torch", tmp_path / "lynx_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    result = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "sys.modules['lynx_tpu'] = None  # import lynx_tpu raises\n"
         "import lynx_tpu_torch\n"
         f"assert lynx_tpu_torch.__file__.startswith({str(tmp_path)!r}), lynx_tpu_torch.__file__\n"
         "from lynx_tpu_torch.models import ares_ea_segment, ares_lattice\n"
         "lattice = ares_lattice(device='cpu')\n"
         "assert len(lattice.elements) == 195, len(lattice.elements)\n"
         "assert len(ares_ea_segment(device='cpu').elements) == 13\n"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr


def test_lattice_file_is_the_jax_packages_byte_for_byte():
    """The port ships its own copy of the ARES lattice file: it stays the
    reference's, byte for byte."""
    ours = REPO / "lynx_tpu_torch" / "models" / "resources" / "ares_lattice.json"
    reference = REPO / "lynx_tpu" / "models" / "resources" / "ares_lattice.json"
    assert ours.read_bytes() == reference.read_bytes()
