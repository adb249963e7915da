"""What the corpus generators share: a seeded generator on the device, a
random rotation and the power-law and Zipf weights of bench.py's recipes."""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def rotation(d: int, g: torch.Generator, device) -> torch.Tensor:
    """A random orthogonal [d, d] matrix: the Q of a normal matrix drawn on
    the device, factored on the host in float64 so that it does not depend
    on the device's solver."""
    a = torch.randn(d, d, generator=g, device=device, dtype=torch.float32)
    return torch.linalg.qr(a.cpu().double())[0].float().to(device)


def power_law(n: int, exponent: float, device) -> torch.Tensor:
    """i ** exponent for i = 1..n, float64."""
    return torch.arange(1, n + 1, device=device, dtype=torch.float64) ** exponent
