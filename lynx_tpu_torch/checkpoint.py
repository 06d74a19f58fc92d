"""Checkpoints of lattices, beams and optimizer state (counterpart of
``lynx_tpu.checkpoint``, which uses orbax).

:func:`save` stores the tensors an object holds with ``torch.save``: a
``Segment``'s or element's fields, a beam's tensors, a ``torch.optim``
optimizer's ``state_dict``, and any dict, list or tuple of these, moved to
the host.  :func:`restore` loads them with ``torch.load(weights_only=True)``
and rebuilds the object from a template of the same structure (a freshly
built segment, beam or optimizer), as the JAX package restores a pytree
from a template: the template gives the classes, names and flags, the file
gives the values (tensors, and the numbers in a dict, list or tuple).
Tensors go to the template's devices and dtypes, and a field that is an
``nn.Parameter`` in the template comes back as one.  An optimizer
template takes its state through ``load_state_dict`` and is returned.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Union

import torch

from lynx_tpu_torch.accelerator import Element, Segment
from lynx_tpu_torch.particles import ParameterBeam, ParticleBeam

#: The tensor fields of each beam type, in constructor order.
_BEAM_FIELDS = {
    ParticleBeam: ("particles", "energy", "particle_charges", "survival"),
    ParameterBeam: ("_mu", "_cov", "energy", "total_charge"),
}


def _fields(element: Element) -> dict:
    """An element's tensors: its buffers, and any field made an
    ``nn.Parameter`` (a magnet being tuned)."""
    fields = {**element._parameters, **element._buffers}
    return {name: value for name, value in fields.items() if value is not None}


def _to_payload(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.optim.Optimizer):
        return _to_payload(obj.state_dict())
    if isinstance(obj, Segment):
        return [_to_payload(element) for element in obj.elements]
    if isinstance(obj, Element):
        return _to_payload(_fields(obj))
    if type(obj) in _BEAM_FIELDS:
        return [_to_payload(getattr(obj, field)) for field in _BEAM_FIELDS[type(obj)]]
    if isinstance(obj, dict):
        return {key: _to_payload(value) for key, value in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_payload(value) for value in obj)
    return obj


def _mismatch(template: Any, saved: Any) -> ValueError:
    return ValueError(
        f"checkpoint does not match its template: {type(template).__name__} against a saved"
        f" {type(saved).__name__}"
    )


def _from_payload(template: Any, saved: Any) -> Any:
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise _mismatch(template, saved)
        return saved.to(device=template.device, dtype=template.dtype)
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(saved)
        return template
    if isinstance(template, Segment):
        if not isinstance(saved, list) or len(saved) != len(template.elements):
            raise _mismatch(template, saved)
        return Segment(
            [_from_payload(element, s) for element, s in zip(template.elements, saved)],
            name=template.name,
        )
    if isinstance(template, Element):
        fields = _from_payload(_fields(template), saved)
        for name, parameter in template._parameters.items():
            if parameter is not None:
                fields[name] = torch.nn.Parameter(fields[name], parameter.requires_grad)
        return template.replace(**fields)
    if type(template) in _BEAM_FIELDS:
        fields = [getattr(template, field) for field in _BEAM_FIELDS[type(template)]]
        return type(template)(*_from_payload(fields, saved))
    if isinstance(template, dict):
        if not isinstance(saved, dict) or saved.keys() != template.keys():
            raise _mismatch(template, saved)
        return {key: _from_payload(value, saved[key]) for key, value in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise _mismatch(template, saved)
        return type(template)(_from_payload(t, s) for t, s in zip(template, saved))
    if template is None or isinstance(template, (bool, int, float, str)):
        if type(saved) is not type(template):
            raise _mismatch(template, saved)
        return saved
    return template


def save(path: Union[str, Path], obj: Any) -> None:
    """Save a Segment, a beam, an optimizer's state, or a dict, list or
    tuple of these (``torch.save`` of their tensors, on the host)."""
    torch.save(_to_payload(obj), Path(path))


def restore(path: Union[str, Path], template: Any) -> Any:
    """Restore what :func:`save` stored, rebuilt on ``template``: an object
    of the same structure, whose tensors give the devices and dtypes."""
    return _from_payload(template, torch.load(Path(path), weights_only=True))
