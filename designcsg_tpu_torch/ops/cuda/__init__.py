"""CUDA kernels generated per scene: sources, build and wrappers."""
