"""lynx-tpu's PyTorch port, for NVIDIA Hopper GPUs.

The first slice: the ARES Experimental Area track of a ParticleBeam and the
screen read, with the windowed screen histogram as a hand-written CUDA
kernel (``csrc/window_histogram.cu``).  ``lynx_tpu`` (JAX) is the reference
the port is held against; this package never imports JAX.
"""

from lynx_tpu_torch import functional  # noqa: F401
from lynx_tpu_torch.accelerator import (  # noqa: F401
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    Screen,
    Segment,
    VerticalCorrector,
)
from lynx_tpu_torch.functional import track  # noqa: F401
from lynx_tpu_torch.particles import Beam, ParameterBeam, ParticleBeam  # noqa: F401
