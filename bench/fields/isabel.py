"""The ``isabel`` formula: four Gaussian blobs of random centre, width and
height, plus Gaussian noise, drawn on the device from a layout number and
``(seed, request index)``.

The same layout, seed and index give the same field on the same kind of
device; the field is made in a few large calls, with a
``torch.Generator`` on that device, and never leaves it.
"""

from __future__ import annotations

import torch

from bench.fields import request_seed

LAYOUT_SEED = 0x15AB


def make(dims, seed: int, index: int, layout: int, device,
         blobs: int = 4, noise: float = 0.01) -> torch.Tensor:
    """Flat (nx * ny * nz,) float32 field, x fastest.  Coordinates are
    normalised to [0, 1] on each axis; blob centres in [0.2, 0.8], widths
    in [0.08, 0.25], heights in [0.5, 1.5], drawn from the ``layout``
    number alone (the same blobs for every seed); noise of standard
    deviation ``noise``, drawn from ``(seed, index)``."""
    nx, ny, nz = dims
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(request_seed(LAYOUT_SEED, layout))
    u = torch.rand((blobs, 5), generator=gen, device=dev,
                   dtype=torch.float64)
    gen.manual_seed(request_seed(seed, index))
    c = 0.2 + 0.6 * u[:, :3]
    s = 0.08 + 0.17 * u[:, 3]
    a = 0.5 + u[:, 4]
    axes = [torch.linspace(0.0, 1.0, m, device=dev, dtype=torch.float64)
            if m > 1 else torch.zeros(1, device=dev, dtype=torch.float64)
            for m in (nx, ny, nz)]
    f = torch.randn((nz, ny, nx), generator=gen, device=dev,
                    dtype=torch.float32).mul_(noise)
    for i in range(blobs):
        w = -0.5 / (s[i] * s[i])
        ex, ey, ez = (torch.exp(w * (ax - c[i, k]) ** 2)
                      for k, ax in enumerate(axes))
        blob = (a[i] * ez[:, None, None] * ey[None, :, None]
                * ex[None, None, :])
        f += blob.float()
        del blob
    return f.reshape(-1)
