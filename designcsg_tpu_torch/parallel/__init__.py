"""Fitting (and, later, multi-device layouts) of the PyTorch/CUDA port."""
