"""Example designs ported so far (the reference's Designs/ folder)."""

from __future__ import annotations

import importlib


def design_module(name: str):
    """The module of a builtin design ('design1' or 'design2'), whose
    ``build(compiler=None)`` makes it.  Logo raises until its baked letter
    field is ported (ROADMAP.md queue 1, item 3)."""
    name = name.lower()
    if name in ("design1", "design2"):
        return importlib.import_module(f"{__name__}.{name}")
    if name == "logo":
        raise NotImplementedError(
            f"design {name!r} is not ported yet (ROADMAP.md queue 1, item 3)"
        )
    raise KeyError(f"unknown design {name!r}")


def get_design(name: str):
    """Build a builtin design by name (see :func:`design_module`)."""
    return design_module(name).build()
