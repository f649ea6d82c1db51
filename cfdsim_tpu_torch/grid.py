"""Structured uniform grids (the 2D ``Grid`` of ``cfdsim_tpu.grid``).

A static, hashable description of the mesh: spacings are Python floats so
they enter every stencil as compile-free scalar constants, and arrays are
laid out (ny, nx) with x along the contiguous axis. Tensor builders take an
explicit ``device``; nothing here picks one.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform 2D structured grid (node-centered by default).

    ``ng`` ghost layers extend the domain on every side. Interior shape is
    (ny, nx); padded shape is (ny + 2*ng, nx + 2*ng).
    """

    nx: int
    ny: int
    x_min: float = 0.0
    x_max: float = 1.0
    y_min: float = 0.0
    y_max: float = 1.0
    ng: int = 0
    # node: points at domain boundaries, dx = L/(n-1)
    # cell: cell centers, dx = L/n
    centering: str = "node"

    def __post_init__(self):
        if self.centering not in ("node", "cell"):
            raise ValueError(f"unknown centering {self.centering!r}")
        if self.nx < 4 or self.ny < 4:
            raise ValueError(f"grid must be at least 4x4, got {self.ny}x{self.nx}")

    @cached_property
    def dx(self) -> float:
        n = self.nx - 1 if self.centering == "node" else self.nx
        return (self.x_max - self.x_min) / n

    @cached_property
    def dy(self) -> float:
        n = self.ny - 1 if self.centering == "node" else self.ny
        return (self.y_max - self.y_min) / n

    @property
    def shape(self) -> tuple[int, int]:
        """Padded array shape (ny_total, nx_total) including ghosts."""
        return (self.ny + 2 * self.ng, self.nx + 2 * self.ng)

    @property
    def interior(self) -> tuple[slice, slice]:
        """Slices selecting the physical interior of a padded array."""
        if self.ng == 0:
            return (slice(None), slice(None))
        return (slice(self.ng, -self.ng), slice(self.ng, -self.ng))

    @property
    def n_cells(self) -> int:
        return self.nx * self.ny

    def x_coords(self) -> np.ndarray:
        """1D x coordinates, including ghost points if ng > 0."""
        if self.centering == "node":
            x0, x1 = self.x_min - self.ng * self.dx, self.x_max + self.ng * self.dx
            return np.linspace(x0, x1, self.nx + 2 * self.ng)
        i = np.arange(-self.ng, self.nx + self.ng) + 0.5
        return self.x_min + i * self.dx

    def y_coords(self) -> np.ndarray:
        if self.centering == "node":
            y0, y1 = self.y_min - self.ng * self.dy, self.y_max + self.ng * self.dy
            return np.linspace(y0, y1, self.ny + 2 * self.ng)
        j = np.arange(-self.ng, self.ny + self.ng) + 0.5
        return self.y_min + j * self.dy

    def meshgrid(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, Y) arrays of shape (ny_total, nx_total); row i = y, col j = x."""
        return np.meshgrid(self.x_coords(), self.y_coords(), indexing="xy")

    def zeros(self, dtype=torch.float32, *, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=dtype, device=device)

    def full(self, value, dtype=torch.float32, *, device) -> torch.Tensor:
        return torch.full(self.shape, value, dtype=dtype, device=device)

    def scaled(self, factor: int) -> "Grid":
        """A grid with nx, ny multiplied by ``factor`` (same domain)."""
        return dataclasses.replace(self, nx=self.nx * factor, ny=self.ny * factor)
