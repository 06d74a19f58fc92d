"""Bmad lattice-file converter (counterpart of ``lynx_tpu.converters.bmad``).

Designed around the LCLS lattice: recursive ``call, file =`` inclusion with
``$ENV`` expansion, ``&``/``,``/``{`` line continuations, arithmetic
expressions in Bmad's math context, ``type::name*`` wildcards, property and
variable assignment, element, line and overlay definitions, ``use``-line
selection, and strict validation that raises on element attributes the
converter does not understand.  :class:`BmadParser` evaluates expressions
in a sandbox that gives lattice files no builtins.
"""

from __future__ import annotations

import math
import os
import re
from copy import deepcopy
from pathlib import Path
from typing import Any, Optional

import scipy.constants
import torch
from scipy.constants import physical_constants

from lynx_tpu_torch import accelerator as acc
from lynx_tpu_torch.log import get_logger
from lynx_tpu_torch.utils import resolve_device

logger = get_logger("converters.bmad")


def read_clean_lines(lattice_file_path: Path) -> list[str]:
    """Recursively read lines, stripping comments/blanks and inlining
    ``call, file =`` includes (with ``$ENV`` parts resolved)."""
    with open(lattice_file_path) as f:
        lines = f.readlines()

    lines = [re.sub(r"!.*", "", line).strip() for line in lines]
    lines = [line for line in lines if line]

    replaced_lines = []
    for line in lines:
        if line.lower().startswith("call, file ="):
            external = Path(line.split("=", 1)[1].strip())
            resolved = Path(
                *[
                    os.environ[part[1:]] if part.startswith("$") else part
                    for part in external.parts
                ]
            )
            if not resolved.is_absolute():
                resolved = lattice_file_path.parent / resolved
            replaced_lines += read_clean_lines(resolved)
        else:
            replaced_lines.append(line)

    # Lower-case late: environment variables in include paths are
    # case-sensitive.
    return [line.lower().strip() for line in replaced_lines]


def merge_delimiter_continued_lines(
    lines: list[str], delimiter: str, remove_delimiter: bool = False
) -> list[str]:
    """Merge lines ending in ``delimiter`` with their continuation lines."""
    merged: list[Optional[str]] = list(lines)
    for i in range(len(merged) - 1):
        if merged[i] is None:
            continue
        j = i + 1
        while merged[i].endswith(delimiter) and j < len(merged):
            continuation = merged[j]
            if continuation is None:
                j += 1
                continue
            head = merged[i][:-1] if remove_delimiter else merged[i]
            merged[i] = head + continuation
            merged[j] = None
            j += 1
    return [line.strip() for line in merged if line is not None]


_KEYWORDS = ("open", "electron", "t", "f", "traveling_wave", "full")


class BmadParser:
    """Parses cleaned+merged Bmad lines into a context dictionary."""

    PROPERTY_ASSIGNMENT = re.compile(r"[a-z0-9_\*:]+\[[a-z0-9_%]+\]\s*=.*")
    VARIABLE_ASSIGNMENT = re.compile(r"[a-z0-9_]+\s*=.*")
    ELEMENT_DEFINITION = re.compile(r"[a-z0-9_]+\s*\:\s*[a-z0-9_]+.*")
    LINE_DEFINITION = re.compile(r"[a-z0-9_]+\s*\:\s*line\s*=\s*\(.*\)")
    OVERLAY_DEFINITION = re.compile(r"[a-z0-9_]+\s*\:\s*overlay\s*=\s*\{.*")
    USE_LINE = re.compile(r"use\s*\,\s*[a-z0-9_]+")

    def __init__(self) -> None:
        self.context: dict = {
            "pi": scipy.constants.pi,
            "twopi": 2 * scipy.constants.pi,
            "c_light": scipy.constants.c,
            "emass": physical_constants["electron mass energy equivalent in MeV"][0]
            * 1e-3,
            "m_electron": (
                physical_constants["electron mass energy equivalent in MeV"][0] * 1e6
            ),
            "sqrt": math.sqrt,
            "asin": math.asin,
            "sin": math.sin,
            "cos": math.cos,
            "tan": math.tan,
            "atan": math.atan,
            "exp": math.exp,
            "log": math.log,
            "abs_func": abs,
            "raddeg": scipy.constants.degree,
        }

    # -- expression evaluation ----------------------------------------------
    def evaluate(self, expression: str) -> Any:
        expression = expression.strip()
        try:
            return int(expression)
        except ValueError:
            pass
        try:
            return float(expression)
        except ValueError:
            pass
        if expression in _KEYWORDS:
            return expression
        if expression in self.context:
            return self.context[expression]

        try:
            # ``name[prop]`` -> ``name['prop']``, ``^`` -> ``**``; the LCLS
            # lattice overloads ``abs`` as an element name, hence abs_func.
            prepared = re.sub(r"\[([a-z0-9_%]+)\]", r"['\1']", expression)
            prepared = prepared.replace("^", "**")
            prepared = re.sub(r"abs\(", r"abs_func(", prepared)
            sandbox = dict(self.context)
            sandbox["__builtins__"] = {}
            return eval(prepared, sandbox)  # noqa: S307 — sandboxed, no builtins
        except SyntaxError:
            # Strings like "a:b:c" are aliases — return verbatim.
            return expression
        except (NameError, TypeError, KeyError):
            return expression

    # -- statement handlers --------------------------------------------------
    def resolve_wildcard(self, pattern_string: str) -> list[str]:
        """Resolve ``type::name-pattern`` wildcards against known elements."""
        object_type, object_name = pattern_string.split("::")
        pattern = object_name.replace("*", ".*").replace("%", ".")
        return [
            key
            for key in self.context
            if re.fullmatch(pattern, key)
            and isinstance(self.context[key], dict)
            and self.context[key].get("element_type") == object_type
        ]

    def assign_property(self, line: str) -> None:
        match = re.fullmatch(r"([a-z0-9_\*:]+)\[([a-z0-9_%]+)\]\s*=(.*)", line)
        object_name = match.group(1).strip()
        property_name = match.group(2).strip()
        value = self.evaluate(match.group(3))
        names = (
            self.resolve_wildcard(object_name)
            if ("*" in object_name or "%" in object_name)
            else [object_name]
        )
        for name in names:
            self.context.setdefault(name, {})[property_name] = value

    def assign_variable(self, line: str) -> None:
        match = re.fullmatch(r"([a-z0-9_]+)\s*=(.*)", line)
        self.context[match.group(1).strip()] = self.evaluate(match.group(2))

    def define_element(self, line: str) -> None:
        match = re.fullmatch(r"([a-z0-9_]+)\s*\:\s*([a-z0-9_]+)(\,(.*))?", line)
        element_name = match.group(1).strip()
        element_type = match.group(2).strip()

        if element_type in self.context:
            properties = deepcopy(self.context[element_type])  # sub-classing
        else:
            properties = {"element_type": element_type}

        if match.group(3) is not None:
            property_pattern = (
                r"([a-z0-9_]+\s*\=\s*\"[^\"]+\"|[a-z0-9_]+\s*\=\s*[^\=\,\"]+)"
            )
            for property_string in re.findall(property_pattern, match.group(4)):
                key, expression = property_string.split("=", 1)
                properties[key.strip()] = self.evaluate(expression)

        self.context[element_name] = properties

    def define_line(self, line: str) -> None:
        match = re.fullmatch(r"([a-z0-9_]+)\s*\:\s*line\s*=\s*\((.*)\)", line)
        self.context[match.group(1).strip()] = [
            name.strip() for name in match.group(2).split(",")
        ]

    def define_overlay(self, line: str) -> None:
        knot = re.fullmatch(
            r"([a-z0-9_]+)\s*\:\s*overlay\s*=\s*\{(.*)\}\s*\,\s*var\s*=\s*"
            r"\{\s*([a-z0-9_]+)\s*\}\s*\,\s*x_knot\s*=\s*\{(.*)\}",
            line,
        )
        expr = re.fullmatch(
            r"([a-z0-9_]+)\s*\:\s*overlay\s*=\s*\{(.*)\}\s*\,\s*var\s*=\s*"
            r"\{(.*)\}\s*(\,.*)*",
            line,
        )
        if knot:
            self.context[knot.group(1).strip()] = {
                "overlay_definition": knot.group(2).strip(),
                "overlay_variable": knot.group(3).strip(),
                "overlay_x_knot": knot.group(4).strip(),
            }
        elif expr:
            parameters = expr.group(4)
            self.context[expr.group(1).strip()] = {
                "overlay_definition": expr.group(2).strip(),
                "overlay_variables": expr.group(3).strip(),
                "overlay_parameters": (
                    parameters.strip()[1:].strip() if parameters is not None else None
                ),
            }
        else:
            raise ValueError(f"Overlay definition {line} not understood.")

    def parse_use_line(self, line: str) -> None:
        match = re.fullmatch(r"use\s*\,\s*([a-z0-9_]+)", line)
        self.context["__use__"] = match.group(1).strip()

    def parse(self, lines: list[str]) -> dict:
        for line in lines:
            if self.PROPERTY_ASSIGNMENT.fullmatch(line):
                self.assign_property(line)
            elif self.VARIABLE_ASSIGNMENT.fullmatch(line):
                self.assign_variable(line)
            elif self.LINE_DEFINITION.fullmatch(line):
                self.define_line(line)
            elif self.OVERLAY_DEFINITION.fullmatch(line):
                self.define_overlay(line)
            elif self.ELEMENT_DEFINITION.fullmatch(line):
                self.define_element(line)
            elif self.USE_LINE.fullmatch(line):
                self.parse_use_line(line)
        return self.context


def validate_understood_properties(understood: list, properties: dict) -> None:
    """Raise if an element has a property the converter does not understand:
    an unknown attribute is never dropped silently."""
    for name in properties:
        if name not in understood:
            raise ValueError(
                f"Property {name} with value {properties[name]} for element type"
                f" {properties['element_type']} is currently not understood."
                f" Other values in properties are {list(properties.keys())}."
            )


def convert_element(
    name: str, context: dict, dtype: torch.dtype = torch.float32, device=None
) -> acc.Element:
    """Convert one parsed Bmad object (an element or a line) to the port's
    element, on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    parsed = context[name]

    if isinstance(parsed, list):  # a line -> Segment
        return acc.Segment(
            elements=[convert_element(element, context, dtype, device) for element in parsed],
            name=name,
        )
    if not (isinstance(parsed, dict) and "element_type" in parsed):
        raise ValueError(f"Unknown Bmad element type for {name=}")

    element_type = parsed["element_type"]
    kw = dict(name=name, dtype=dtype, device=device)

    def arr(key, default=None):
        value = parsed[key] if default is None else parsed.get(key, default)
        return torch.tensor([value], dtype=dtype, device=device)

    def check(*understood):
        validate_understood_properties(["element_type", *understood], parsed)

    if element_type == "marker":
        check("alias", "type", "sr_wake", r"sr_wake%scale_with_length", r"sr_wake%amp_scale")
        return acc.Marker(**kw)
    if element_type in ("monitor", "instrument"):
        check("alias", "type", "l")
        if "l" in parsed:
            return acc.Drift(length=arr("l"), **kw)
        return acc.Marker(**kw)
    if element_type == "pipe":
        check("alias", "type", "l", "descrip")
        return acc.Drift(length=arr("l"), **kw)
    if element_type == "drift":
        check("l", "type", "descrip")
        return acc.Drift(length=arr("l"), **kw)
    if element_type in ("hkicker", "vkicker"):
        check("type", "alias", "kick", "l")
        corrector = acc.HorizontalCorrector if element_type == "hkicker" else acc.VerticalCorrector
        return corrector(length=arr("l", 0.0), angle=arr("kick", 0.0), **kw)
    if element_type == "sbend":
        check("alias", "type", "hgap", "l", "angle", "e1", "e2", "fint", "fintx",
              "fringe_type", "ref_tilt", "g", "dg")
        return acc.Dipole(
            length=arr("l"),
            gap=arr("hgap", 0.0),
            angle=arr("angle", 0.0),
            e1=arr("e1"),
            e2=arr("e2", 0.0),
            tilt=arr("ref_tilt", 0.0),
            fringe_integral=arr("fint", 0.0),
            fringe_integral_exit=arr("fintx") if "fintx" in parsed else None,
            **kw,
        )
    if element_type == "quadrupole":
        check("l", "k1", "type", "aperture", "alias", "tilt")
        return acc.Quadrupole(length=arr("l"), k1=arr("k1"), tilt=arr("tilt", 0.0), **kw)
    if element_type == "solenoid":
        check("l", "ks", "alias")
        return acc.Solenoid(length=arr("l"), k=arr("ks"), **kw)
    if element_type == "lcavity":
        check("l", "type", "rf_frequency", "voltage", "phi0", "sr_wake", "cavity_type", "alias")
        # Bmad's phi0 is in turns; the port's phase is in degrees, of the
        # opposite sign.
        return acc.Cavity(
            length=arr("l"),
            voltage=arr("voltage", 0.0),
            phase=torch.tensor(
                [-math.degrees(parsed.get("phi0", 0.0) * 2 * math.pi)], dtype=dtype, device=device
            ),
            frequency=arr("rf_frequency"),
            **kw,
        )
    if element_type in ("rcollimator", "ecollimator"):
        check("l", "alias", "type", "x_limit", "y_limit")
        return acc.Aperture(
            x_max=arr("x_limit", float("inf")),
            y_max=arr("y_limit", float("inf")),
            shape="rectangular" if element_type == "rcollimator" else "elliptical",
            **kw,
        )
    if element_type == "wiggler":
        check("type", "l_period", "n_period", "b_max", "l", "alias", "tilt", "ds_step")
        return acc.Undulator(length=arr("l"), **kw)
    if element_type == "patch":
        check("tilt")
        return acc.Drift(length=arr("l", 0.0), **kw)

    logger.warning(
        "Element %s of type %s cannot be converted correctly. Using drift section instead.",
        name,
        element_type,
    )
    return acc.Drift(length=arr("l", 0.0), **kw)


def convert_bmad_lattice(
    bmad_lattice_file_path: Path,
    environment_variables: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> acc.Element:
    """Convert a Bmad lattice file (with its includes) to a Segment, on the
    card unless ``device`` says otherwise.  ``environment_variables`` are
    set in ``os.environ`` first, for ``$ENV`` parts of include paths."""
    if environment_variables is not None:
        for key, value in environment_variables.items():
            os.environ[key] = value

    resolved = Path(
        *[
            os.environ[part[1:]] if part.startswith("$") else part
            for part in Path(bmad_lattice_file_path).parts
        ]
    )

    lines = read_clean_lines(resolved)
    merged = merge_delimiter_continued_lines(lines, "&", remove_delimiter=True)
    merged = merge_delimiter_continued_lines(merged, ",", remove_delimiter=False)
    merged = merge_delimiter_continued_lines(merged, "{", remove_delimiter=False)

    context = BmadParser().parse(merged)
    return convert_element(context["__use__"], context, dtype, resolve_device(device))
