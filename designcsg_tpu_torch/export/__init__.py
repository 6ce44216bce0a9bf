"""Mesh export: pipeline and STL/PLY writers."""
