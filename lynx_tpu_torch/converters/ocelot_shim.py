"""Duck-typed stand-ins for Ocelot's element classes (counterpart of
``lynx_tpu.converters.ocelot_shim``).

The converter (:mod:`lynx_tpu_torch.converters.ocelot`) matches elements by
class name, so any object with Ocelot's attribute names converts.  These
shims carry just the attributes the converter reads (``l``, ``id`` and each
type's strengths), so Ocelot-format lattice files run without Ocelot.
"""

from __future__ import annotations

from typing import Optional


class OcelotElementShim:
    """Base shim: stores keyword attributes; ``eid`` becomes ``id``."""

    _defaults: dict = {}

    def __init__(self, l: float = 0.0, eid: Optional[str] = None, **kwargs):  # noqa: E741
        self.l = l  # noqa: E741
        self.id = eid
        for key, value in type(self)._defaults.items():
            setattr(self, key, value)
        for key, value in kwargs.items():
            setattr(self, key, value)
        # Ocelot semantics: fintx defaults to fint when not given.
        if hasattr(self, "fint") and getattr(self, "fintx", None) is None:
            self.fintx = self.fint

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.id!r}, l={self.l!r})"


class Drift(OcelotElementShim):
    pass


class Quadrupole(OcelotElementShim):
    _defaults = {"k1": 0.0, "k2": 0.0, "tilt": 0.0}


class Solenoid(OcelotElementShim):
    _defaults = {"k": 0.0}


class Hcor(OcelotElementShim):
    _defaults = {"angle": 0.0}


class Vcor(OcelotElementShim):
    _defaults = {"angle": 0.0}


class Bend(OcelotElementShim):
    _defaults = {
        "angle": 0.0,
        "e1": 0.0,
        "e2": 0.0,
        "tilt": 0.0,
        "fint": 0.0,
        "fintx": None,
        "gap": 0.0,
        "k1": 0.0,
    }


class SBend(Bend):
    pass


class RBend(Bend):
    pass


class Cavity(OcelotElementShim):
    _defaults = {"v": 0.0, "freq": 0.0, "phi": 0.0}


class TDCavity(OcelotElementShim):
    _defaults = {"v": 0.0, "freq": 0.0, "phi": 0.0}


class Monitor(OcelotElementShim):
    pass


class Marker(OcelotElementShim):
    pass


class Undulator(OcelotElementShim):
    _defaults = {"lperiod": 0.0, "nperiods": 0, "Kx": 0.0}


class Aperture(OcelotElementShim):
    _defaults = {"xmax": float("inf"), "ymax": float("inf"), "type": "rect"}
