"""Pallas kernels (Triton route) for the geodesic march and shading."""

from bhx.kernels.march_pallas import march_pallas, MarchKernelConfig

__all__ = ["march_pallas", "MarchKernelConfig"]
