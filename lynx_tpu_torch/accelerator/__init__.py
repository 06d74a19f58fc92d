from lynx_tpu_torch.accelerator.aperture import Aperture  # noqa: F401
from lynx_tpu_torch.accelerator.bpm import BPM  # noqa: F401
from lynx_tpu_torch.accelerator.cavity import Cavity  # noqa: F401
from lynx_tpu_torch.accelerator.correctors import (  # noqa: F401
    HorizontalCorrector,
    VerticalCorrector,
)
from lynx_tpu_torch.accelerator.custom_transfer_map import CustomTransferMap  # noqa: F401
from lynx_tpu_torch.accelerator.dipole import Dipole, RBend  # noqa: F401
from lynx_tpu_torch.accelerator.drift import Drift  # noqa: F401
from lynx_tpu_torch.accelerator.element import Element  # noqa: F401
from lynx_tpu_torch.accelerator.marker import Marker  # noqa: F401
from lynx_tpu_torch.accelerator.quadrupole import Quadrupole  # noqa: F401
from lynx_tpu_torch.accelerator.screen import Screen  # noqa: F401
from lynx_tpu_torch.accelerator.segment import Segment  # noqa: F401
from lynx_tpu_torch.accelerator.solenoid import Solenoid  # noqa: F401
from lynx_tpu_torch.accelerator.transverse_deflecting_cavity import (  # noqa: F401
    TransverseDeflectingCavity,
)
from lynx_tpu_torch.accelerator.undulator import Undulator  # noqa: F401

#: Element classes by name, for the converters.
ELEMENT_CLASSES = {
    cls.__name__: cls
    for cls in (
        Aperture, BPM, Cavity, CustomTransferMap, Dipole, Drift, HorizontalCorrector, Marker,
        Quadrupole, RBend, Screen, Solenoid, TransverseDeflectingCavity, Undulator,
        VerticalCorrector,
    )
}
