"""Example designs ported so far (the reference's Designs/ folder)."""

from __future__ import annotations


def get_design(name: str):
    """Build a design by name.  Only 'design1' is ported; the others raise
    (ROADMAP.md queue 1, item 3)."""
    name = name.lower()
    if name == "design1":
        from . import design1

        return design1.build()
    if name in ("design2", "logo"):
        raise NotImplementedError(
            f"design {name!r} is not ported yet (ROADMAP.md queue 1, item 3)"
        )
    raise KeyError(f"unknown design {name!r}")
