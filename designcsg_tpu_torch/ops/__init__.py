"""SDF evaluation, rendering and meshing operators."""
