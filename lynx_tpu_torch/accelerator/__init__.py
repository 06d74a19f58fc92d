from lynx_tpu_torch.accelerator.correctors import (  # noqa: F401
    HorizontalCorrector,
    VerticalCorrector,
)
from lynx_tpu_torch.accelerator.drift import Drift  # noqa: F401
from lynx_tpu_torch.accelerator.element import Element  # noqa: F401
from lynx_tpu_torch.accelerator.marker import Marker  # noqa: F401
from lynx_tpu_torch.accelerator.quadrupole import Quadrupole  # noqa: F401
from lynx_tpu_torch.accelerator.screen import Screen  # noqa: F401
from lynx_tpu_torch.accelerator.segment import Segment  # noqa: F401

#: Element classes by name, for the converters.  A class that is not here
#: is not ported yet.
ELEMENT_CLASSES = {
    cls.__name__: cls
    for cls in (Drift, HorizontalCorrector, Marker, Quadrupole, Screen, VerticalCorrector)
}
