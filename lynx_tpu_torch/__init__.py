"""lynx-tpu's PyTorch port, for NVIDIA Hopper GPUs.

Ported so far: every element type of the full ARES lattice; the beams'
constructors (parameters, Twiss, ASTRA, Ocelot) and their Twiss and
emittance diagnostics; the converters (LatticeJSON load and save, Bmad,
Ocelot, NX Tables, ASTRA) and checkpoints (``checkpoint``); the ARES
Experimental Area track of a ParticleBeam and the screen read, with the windowed screen histogram as a hand-written CUDA kernel
(``csrc/window_histogram.cu``); and the batched-settings sweep: the
ARES-EA environment (``envs``), the gradient tuner (``tuning``), the fused
ParameterBeam sweep with its backward, the per-setting particle push and
the particle moment sweep, as hand-written CUDA kernels
(``ops/fused_track.py``); the RL-training and tuning slice: ``metrics``,
the env's Gymnasium adapter, ``debug``, ``profiling``, the lattice plots
and the examples (``lynx_tpu_torch.examples``, PPO among them).
``lynx_tpu`` (JAX)
is the reference the port is held against; this package never imports JAX.
"""

from lynx_tpu_torch import converters  # noqa: F401
from lynx_tpu_torch import functional  # noqa: F401
from lynx_tpu_torch.accelerator import (  # noqa: F401
    BPM,
    Aperture,
    Cavity,
    CustomTransferMap,
    Dipole,
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    RBend,
    Screen,
    Segment,
    Solenoid,
    Undulator,
    VerticalCorrector,
)
from lynx_tpu_torch.functional import moment_sufficient, track  # noqa: F401
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam  # noqa: F401
from lynx_tpu_torch.random import seed  # noqa: F401
from lynx_tpu_torch.tuning import make_tuner, tune, tune_until  # noqa: F401
