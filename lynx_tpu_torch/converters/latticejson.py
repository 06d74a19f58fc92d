"""LatticeJSON load and save (counterpart of
``lynx_tpu.converters.latticejson``), file-compatible with Cheetah's flavour.

The format: a JSON document with metadata (``"version": "cheetah-0.6"``),
an ``elements`` dict ``{name: [ClassName, params]}`` and a ``lattices``
dict of name -> cell lists (nested lattices allowed).  Class names map to
the port's classes through ``accelerator.ELEMENT_CLASSES``; a class that is
not ported yet raises.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Optional, Tuple

import numpy as np
import torch

from lynx_tpu_torch.accelerator import ELEMENT_CLASSES, Element, Segment
from lynx_tpu_torch.utils import resolve_device

#: Parameters that are configuration (plain Python values), not tensors.
_HOST_KEYS = frozenset({"resolution", "binning", "shape", "is_active"})


def feature_to_plain(value: Any) -> Any:
    """A feature value as a JSON-serialisable plain value (tensors on any
    device as nested lists of Python numbers)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().tolist()
    if isinstance(value, tuple):
        return list(value)
    return value


def plain_to_feature(value: Any, device=None) -> Any:
    """A plain JSON value as a feature: strings and booleans as they are,
    anything else as a tensor, on the card unless ``device`` says otherwise."""
    if isinstance(value, (str, bool)):
        return value
    return torch.as_tensor(value, device=resolve_device(device))


def convert_element(element: Element) -> Tuple[str, str, dict]:
    """Deconstruct an element into (name, class name, parameter dict)."""
    params = {name: feature_to_plain(element.feature(name)) for name in element.defining_features}
    return element.name, element.__class__.__name__, params


def convert_segment(segment: Segment) -> Tuple[dict, dict]:
    """Deconstruct a segment into its elements and lattices dicts
    (recursively for nested segments)."""
    elements: dict = {}
    lattices: dict = {}
    cell = []
    for element in segment.elements:
        if isinstance(element, Segment):
            sub_elements, sub_lattices = convert_segment(element)
            elements.update(sub_elements)
            lattices.update(sub_lattices)
        else:
            name, class_name, params = convert_element(element)
            elements[name] = [class_name, params]
        cell.append(element.name)
    lattices[segment.name] = cell
    return elements, lattices


def save_cheetah_model(
    segment: Segment,
    filename: str,
    title: Optional[str] = None,
    info: str = "This is a placeholder lattice description",
) -> None:
    """Save a segment as LatticeJSON (Cheetah's ``version`` tag)."""
    if title is None:
        title = segment.name if segment.name is not None else "Unnamed Lattice"
    elements, lattices = convert_segment(segment)
    lattice_dict = {
        "version": "cheetah-0.6",
        "title": title,
        "info": info,
        "root": segment.name if segment.name is not None else "cell",
        "elements": elements,
        "lattices": lattices,
    }
    with open(filename, "w") as f:
        f.write(json.dumps(lattice_dict, cls=CompactJSONEncoder, indent=4))


class CompactJSONEncoder(json.JSONEncoder):
    """JSON encoder that indents only the first two levels, so that lattice
    files stay readable (format from nobeam/latticejson)."""

    def encode(self, obj, level=0):
        if isinstance(obj, dict) and level < 2:
            items_indent = (level + 1) * self.indent * " "
            items_string = ",\n".join(
                f"{items_indent}{json.dumps(key)}: {self.encode(value, level=level + 1)}"
                for key, value in obj.items()
            )
            dict_indent = level * self.indent * " "
            newline = "\n" if level == 0 else ""
            return f"{{\n{items_string}\n{dict_indent}}}{newline}"
        return json.dumps(obj)


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
    packages.  The element lives on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    class_name, params = lattice_dict["elements"][name]
    _check_ported([class_name])
    converted = {
        key: value
        if isinstance(value, (str, bool)) or key in _HOST_KEYS
        else torch.as_tensor(np.asarray(value, dtype=np.float32), device=device)
        for key, value in params.items()
    }
    element = ELEMENT_CLASSES[class_name](name=name, **converted, dtype=dtype, device=device)
    if class_name == "RBend":
        # The file holds an RBend's faces as the element keeps them, angle /
        # 2 added (its defining features); RBend.__init__ adds it again, so
        # the file's values are put back.  The JAX package reloads them
        # shifted twice.
        for face in ("e1", "e2"):
            if face in converted:
                setattr(element, face, converted[face].to(dtype))
    return element


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
    """Load a lattice from a LatticeJSON file onto the card, unless
    ``device`` says otherwise; raise ``NotImplementedError`` naming every
    element type of the file that is not ported yet."""
    lattice_dict = read_lattice_dict(filename)
    _check_ported(class_name for class_name, _ in lattice_dict["elements"].values())
    return parse_segment(lattice_dict["root"], lattice_dict, dtype, resolve_device(device))


def from_jax_arrays(element, device=None, dtype: Optional[torch.dtype] = None) -> Element:
    """Build the port's counterpart of a ``lynx_tpu`` element or segment.

    Duck-typed, so that this package never imports JAX: it reads the JAX
    object's class name, ``name``, its data fields (``_all_data_fields``,
    each converted with ``numpy.asarray``) and its static fields
    (``_all_static_fields``).  Names, classes and every data field carry
    over; ``dtype`` casts the floating fields if given.  The result lives
    on the card unless ``device`` says otherwise.
    """
    device = resolve_device(device)
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
