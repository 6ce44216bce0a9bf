"""The plain reference: each design's field, built from the design's own
upstream definition (``<config>.py``), upstream's viewport frame and the
checks of a written mesh.  Plain PyTorch and NumPy; it imports nothing of
the program under test."""
