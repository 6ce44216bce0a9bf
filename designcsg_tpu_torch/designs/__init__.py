"""Example designs ported so far (the reference's Designs/ folder)."""

from __future__ import annotations

import importlib


def design_module(name: str):
    """The module of a builtin design ('design1', 'design2' or 'logo'),
    whose ``build(compiler=None)`` makes it."""
    name = name.lower()
    if name in ("design1", "design2", "logo"):
        return importlib.import_module(f"{__name__}.{name}")
    raise KeyError(f"unknown design {name!r}")


def get_design(name: str):
    """Build a builtin design by name (see :func:`design_module`)."""
    return design_module(name).build()
