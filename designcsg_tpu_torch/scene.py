"""Hierarchical CSG scene graph.

Mirrors the reference's ``Component`` tree semantics
(reference: scenecompiler.py:261-394): a component is a
brush + material + intrinsic 4x4 transform + subtractive flag + children.
``fabricate`` instantiates a prefab under a new transform; transform
propagation multiplies intrinsics up the parent chain; ``get_commands``
compiles the tree into the flat register-machine tape.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from .constants import OPCODE_VALUES

# Tape arguments are plain integers: a register index, an immediate (brush /
# object bank index), or NULL for unused slots.  The reference wraps these in
# an Argument/Allocator object layer (scenecompiler.py:145-224); the on-tape
# encoding — which the byte-identical buildprocedure.txt goldens pin down —
# is just the integer.
NULL_ARG = -1


class Command(NamedTuple):
    """One scene-build instruction: ``opcode left right dest``.

    ``left``/``right``/``dest`` are register indices or immediates depending
    on the opcode (SURVEY.md Appendix A; parser DrawPane.cpp:355-371)."""

    command_code: str
    left: int
    right: int
    dest: int

    def as_tuple(self):
        return (OPCODE_VALUES[self.command_code], self.left, self.right, self.dest)

    def __str__(self):
        return "{} {} {} {}".format(*self.as_tuple())


class Allocator:
    """Linear register allocation: one register per internal tree node, plus
    the shared scratch register R0 (same register-file layout the reference
    produces, scenecompiler.py:546-558 — allocation order is what the tape
    goldens encode)."""

    def __init__(self):
        self.num_registers = 0
        self.R0: Optional[int] = None

    def allocate(self) -> int:
        register = self.num_registers
        self.num_registers += 1
        return register

    def allocate_scratch(self) -> int:
        self.R0 = self.allocate()
        return self.R0


class Component:
    """A node in the CSG tree (scenecompiler.py:261-387).

    Any component can be treated as a prefab; ``fabricate`` clones it (and its
    subtree) under a new transform.
    """

    def __init__(self, brush, material, transform=None, subtractive=False):
        self.brush = brush
        self.material = material
        self.intrinsic_transform = (
            np.identity(4) if transform is None else np.asarray(transform, dtype=np.float64)
        )
        self.subtractive = bool(subtractive)
        self.propogated_transform = np.identity(4)
        self.children: List["Component"] = []
        self.parent: Optional["Component"] = None
        # Assigned at commit time:
        self.unrolled_index: Optional[int] = None
        self.variable: Optional[int] = None  # this subtree's result register

    # -- tree building -----------------------------------------------------

    def add_child(self, child: "Component") -> "Component":
        self.children.append(child)
        child.parent = self
        return child

    def fabricate(self, transform=None, subtractive=None) -> "Component":
        """Clone this prefab under ``transform`` (scenecompiler.py:293-301).

        Unlike the reference (which always instantiates a plain ``Component``,
        silently dropping intersection join semantics on fabricated
        IntersectionComponents), the clone preserves the subclass.
        """
        sub = self.subtractive if subtractive is None else subtractive
        transform = np.identity(4) if transform is None else transform
        instance = type(self).__new__(type(self))
        Component.__init__(
            instance,
            brush=self.brush,
            material=self.material,
            transform=np.asarray(transform) @ self.intrinsic_transform,
            subtractive=sub,
        )
        for child in self.children:
            instance.add_child(child.fabricate(transform=np.identity(4)))
        return instance

    def apply_transform(self, transform):
        self.intrinsic_transform = np.asarray(transform) @ self.intrinsic_transform

    # -- transform propagation --------------------------------------------

    def propogate_transforms(self):
        """Walk the parent chain multiplying intrinsics (scenecompiler.py:303-309)."""
        self.propogated_transform = self.intrinsic_transform
        current = self
        while current.parent is not None:
            current = current.parent
            self.propogated_transform = (
                current.intrinsic_transform @ self.propogated_transform
            )

    def position(self):
        return (self.propogated_transform @ np.array([0.0, 0.0, 0.0, 1.0]))[0:3]

    def right(self):
        return self.propogated_transform[0:3, 0]

    def up(self):
        return self.propogated_transform[0:3, 1]

    def forward(self):
        return self.propogated_transform[0:3, 2]

    # -- flattening and tape compilation -----------------------------------

    def get_unrolled_components(self) -> List["Component"]:
        components = [self]
        for child in self.children:
            components.extend(child.get_unrolled_components())
        return components

    def _join_mode(self) -> str:
        return "MIN"

    def get_commands(self, allocator: Allocator) -> List[Command]:
        """Emit the register-machine program for this subtree
        (scenecompiler.py:353-387).

        The parent IMPORTs its own brush into its allocated register; each
        leaf child IMPORTs into scratch R0 then MIN (additive) or NEGATE+MAX
        (subtractive) folds into the parent register; a non-leaf child
        compiles recursively and its register folds into the parent.
        """
        join_mode = self._join_mode()
        commands: List[Command] = []
        if not self.children:
            return commands

        commands.append(
            Command("IMPORT", self.brush.bank_index, self.unrolled_index, self.variable)
        )
        for child in self.children:
            if not child.children:
                commands.append(
                    Command(
                        "IMPORT",
                        child.brush.bank_index,
                        child.unrolled_index,
                        allocator.R0,
                    )
                )
                if child.subtractive:
                    commands.append(
                        Command("NEGATE", allocator.R0, NULL_ARG, allocator.R0)
                    )
                    commands.append(
                        Command("MAX", self.variable, allocator.R0, self.variable)
                    )
                else:
                    commands.append(
                        Command(join_mode, self.variable, allocator.R0, self.variable)
                    )
            else:
                commands.extend(child.get_commands(allocator))
                if child.subtractive:
                    commands.append(
                        Command("NEGATE", child.variable, NULL_ARG, allocator.R0)
                    )
                    commands.append(
                        Command("MAX", self.variable, allocator.R0, self.variable)
                    )
                else:
                    commands.append(
                        Command(join_mode, self.variable, child.variable, self.variable)
                    )
        return commands


class IntersectionComponent(Component):
    """A component whose children combine by MAX (intersection); its own
    brush is the space brush (sdf == 0 everywhere), making the fold
    ``max(0, d_1, d_2, ...)`` exactly as the reference does
    (scenecompiler.py:389-394).  Note this clamps interior distances to 0 —
    a reference quirk we reproduce for parity."""

    def _join_mode(self) -> str:
        return "MAX"
