"""LatticeJSON loading (counterpart of the loader in
``lynx_tpu.converters.latticejson``).

The format: a JSON document with an ``elements`` dict ``{name: [ClassName,
params]}`` and a ``lattices`` dict of name -> cell lists (nested lattices
allowed).  Class names map to the port's classes through
``accelerator.ELEMENT_CLASSES``; a class that is not ported yet raises.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

import numpy as np
import torch

from lynx_tpu_torch.accelerator import ELEMENT_CLASSES, Element, Segment

#: Parameters that are configuration (plain Python values), not tensors.
_HOST_KEYS = frozenset({"resolution", "binning", "shape", "is_active"})


def read_lattice_dict(filename: str) -> dict:
    with open(filename, "r") as f:
        return json.load(f)


def _check_ported(class_names: Iterable[str]) -> None:
    missing = sorted(set(class_names) - set(ELEMENT_CLASSES))
    if missing:
        raise NotImplementedError(
            "LatticeJSON element types not ported to lynx_tpu_torch yet: "
            + ", ".join(missing)
        )


def parse_element(
    name: str, lattice_dict: dict, dtype: torch.dtype = torch.float32, device=None
) -> Element:
    """Reconstruct one element from the ``elements`` table.

    Numbers are read through float32, as the JAX loader reads them, so that
    a lattice cast to float64 afterwards holds the same values in both
    packages."""
    class_name, params = lattice_dict["elements"][name]
    _check_ported([class_name])
    converted = {
        key: value
        if isinstance(value, (str, bool)) or key in _HOST_KEYS
        else torch.as_tensor(np.asarray(value, dtype=np.float32))
        for key, value in params.items()
    }
    return ELEMENT_CLASSES[class_name](name=name, **converted, dtype=dtype, device=device)


def parse_segment(
    name: str, lattice_dict: dict, dtype: torch.dtype = torch.float32, device=None
) -> Segment:
    """Reconstruct a segment, resolving nested lattices."""
    elements = []
    for element_name in lattice_dict["lattices"][name]:
        if element_name in lattice_dict["lattices"]:
            elements.append(parse_segment(element_name, lattice_dict, dtype, device))
        else:
            elements.append(parse_element(element_name, lattice_dict, dtype, device))
    return Segment(elements=elements, name=name)


def load_cheetah_model(
    filename: str, dtype: torch.dtype = torch.float32, device=None
) -> Segment:
    """Load a lattice from a LatticeJSON file; raise ``NotImplementedError``
    naming every element type of the file that is not ported yet."""
    lattice_dict = read_lattice_dict(filename)
    _check_ported(class_name for class_name, _ in lattice_dict["elements"].values())
    return parse_segment(lattice_dict["root"], lattice_dict, dtype, device)


def from_jax_arrays(element, device=None, dtype: Optional[torch.dtype] = None) -> Element:
    """Build the port's counterpart of a ``lynx_tpu`` element or segment.

    Duck-typed, so that this package never imports JAX: it reads the JAX
    object's class name, ``name``, its data fields (``_all_data_fields``,
    each converted with ``numpy.asarray``) and its static fields
    (``_all_static_fields``).  Names, classes and every data field carry
    over; ``dtype`` casts the floating fields if given.
    """
    class_name = type(element).__name__
    if class_name == "Segment":
        return Segment(
            [from_jax_arrays(e, device=device, dtype=dtype) for e in element.elements],
            name=element.name,
        )
    _check_ported([class_name])
    data = {}
    for field in type(element)._all_data_fields:
        value = torch.as_tensor(np.array(getattr(element, field)), device=device)
        data[field] = value.to(dtype) if dtype is not None and value.is_floating_point() else value
    static = {
        field: getattr(element, field)
        for field in type(element)._all_static_fields
        if field != "name"
    }
    return ELEMENT_CLASSES[class_name].from_fields(element.name, data, static)
