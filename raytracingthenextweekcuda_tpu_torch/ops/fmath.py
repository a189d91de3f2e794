"""float32 math functions that give the same bits on the CPU and the card.

sqrt, 1/sqrt, sin, cos, exp, log and pow are taken in float64 and rounded
to float32: that is the correctly rounded float32 function (or within a
double rounding of it), whatever library the device calls, so the plain
versions on the CPU, the plain versions on a CUDA device and the kernels
(which call the same CUDA double functions) agree bit for bit. torch's
float32 functions differ between the CPU and CUDA by ulps.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return (1.0 / torch.sqrt(x.double())).float()


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).float()


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).float()


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def pow(x: torch.Tensor, y) -> torch.Tensor:
    """x ** y for x >= 0 (y a float32 tensor or a Python float)."""
    y = y.double() if torch.is_tensor(y) else float(y)
    return torch.pow(x.double(), y).float()


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true division (a CUDA tensor divided by a Python scalar
    may be multiplied by the scalar's reciprocal instead)."""
    return x / torch.full_like(x, s)


__all__ = ["cos", "div", "exp", "log", "pow", "rsqrt", "sin", "sqrt"]
