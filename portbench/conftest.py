"""Puts the small sizes of the cells that ``portbench/tests/conftest.py``
does not list (``portbench/tests/small/<cell>.json``, the configuration's
and traffic's entries replaced, as in ``SMALL``) into its ``SMALL`` as soon
as pytest loads it, so that every test file finds them, whichever files
are collected and in whatever order."""

import json
from pathlib import Path

TESTS = Path(__file__).resolve().parent / "tests"


def small_sizes():
    """``{cell: overrides}`` of the files under ``tests/small``."""
    return {path.stem: json.loads(path.read_text())
            for path in sorted((TESTS / "small").glob("*.json"))}


def pytest_plugin_registered(plugin, manager):
    if Path(getattr(plugin, "__file__", None) or "/").resolve() == TESTS / "conftest.py":
        for name, overrides in small_sizes().items():
            plugin.SMALL.setdefault(name, overrides)
