"""Scalar-field generators mirroring the paper's 8 benchmark datasets
(Sec. VI-A), at configurable resolution.  Each returns a flat (nv,) float32
array in the grid's vid order (x fastest).

- elevation : monotone ramp — pathological single-pair case
- wavelet   : smooth symmetric separable cosines — best-case load balance
- random    : i.i.d. noise — worst case (most pairs, spatially uniform)
- isabel    : few smooth large-scale blobs (hurricane-like)
- backpack  : spatially imbalanced noise (features concentrated in a corner)
- magnetic  : multi-scale noisy (reconnection-like; most pairs overall)
- truss     : periodic lattice with defects (rich symmetric topology)
- pressure  : band-limited turbulence-like noise

Every generator also has a *chunk-seekable* form (:func:`make_field_chunk`):
``make_field_chunk(name, dims, seed, zlo, zhi)`` returns exactly
``make_field(name, dims, seed)`` restricted to z-planes ``[zlo, zhi)``,
holding only O(chunk) memory — the synthetic back-end of
``repro.stream.FunctionSource``, which lets the out-of-core engine run
benchmark fields at resolutions where the full array would not fit.
Deterministic fields evaluate their closed form on the slab coordinates;
rng-backed fields replay the generator bit stream in O(chunk)-sized
blocks, keeping only the requested planes (numpy ``Generator`` draws are
split-invariant: drawing n then m values equals drawing n+m).
``pressure`` synthesizes its band-limited spectrum from a fixed number
of random Fourier modes (drawn once, independent of the range), so every
generator — pressure included — evaluates any vid range from O(chunk)
memory with no full-field materialization.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.grid import Grid

_BLOCK = 1 << 16  # rng replay block (elements); bounds chunk-path memory


def _coords_range(g: Grid, lo: int, hi: int):
    """Normalized (x, y, z) coordinates of vids [lo, hi)."""
    nx, ny, nz = g.dims
    v = np.arange(lo, hi)
    x = (v % nx) / max(nx - 1, 1)
    y = ((v // nx) % ny) / max(ny - 1, 1)
    z = (v // (nx * ny)) / max(nz - 1, 1)
    return x, y, z


def _coords(g: Grid):
    return _coords_range(g, 0, g.nv)


def _replay(rng, draw: Callable, nv: int, lo: int, hi: int) -> np.ndarray:
    """Draw ``nv`` values in blocks, returning only [lo, hi).

    Always consumes exactly ``nv`` draws so the generator lands at the
    same stream position as the full-field ``draw(nv)`` call — fields
    that draw several full-grid arrays in sequence stay aligned."""
    out = np.empty(hi - lo)
    pos = 0
    while pos < nv:
        n = min(_BLOCK, nv - pos)
        block = draw(n)
        a, b = max(lo, pos), min(hi, pos + n)
        if a < b:
            out[a - lo: b - lo] = block[a - pos: b - pos]
        pos += n
    return out


# --------------------------------------------------------------------------
# field formulas: each as f(g, rng, lo, hi) over the vid range [lo, hi)
# --------------------------------------------------------------------------

def _elevation(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    return (x + 10 * y + 100 * z).astype(np.float32)


def _wavelet(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    r2 = (x - .5) ** 2 + (y - .5) ** 2 + (z - .5) ** 2
    f = np.cos(12 * x) * np.cos(10 * y) * np.cos(8 * z) * np.exp(-2 * r2)
    return f.astype(np.float32)


def _random(g, rng, lo, hi):
    return _replay(rng, rng.standard_normal, g.nv, lo, hi).astype(np.float32)


def _isabel(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    f = np.zeros(hi - lo)
    for _ in range(4):
        cx, cy, cz = rng.uniform(0.2, 0.8, 3)
        s = rng.uniform(0.08, 0.25)
        a = rng.uniform(0.5, 1.5)
        f += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
                        / (2 * s * s))
    noise = _replay(rng, rng.standard_normal, g.nv, lo, hi)
    return (f + 0.01 * noise).astype(np.float32)


def _backpack(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    noise = _replay(rng, rng.standard_normal, g.nv, lo, hi)
    weight = np.exp(-4 * ((x - 0.15) ** 2 + (y - 0.2) ** 2 + z ** 2))
    return (noise * weight + 0.5 * x).astype(np.float32)


def _magnetic(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    f = np.sin(20 * x) * np.sin(18 * y) * np.sin(16 * z)
    noise = _replay(rng, rng.standard_normal, g.nv, lo, hi)
    f = f + 0.8 * noise
    return f.astype(np.float32)


def _truss(g, rng, lo, hi):
    x, y, z = _coords_range(g, lo, hi)
    f = np.sin(8 * np.pi * x) ** 2 + np.sin(8 * np.pi * y) ** 2 \
        + np.sin(8 * np.pi * z) ** 2
    # two sequential full-grid draw streams; _replay keeps them aligned
    amp = _replay(rng, rng.standard_normal, g.nv, lo, hi)
    where = _replay(rng, rng.random, g.nv, lo, hi)
    defects = 0.2 * amp * (where < 0.02)
    return (f + defects).astype(np.float32)


_PRESSURE_MODES = 96


def _pressure(g, rng, lo, hi):
    """Band-limited turbulence-like noise with a *local* closed form.

    A finite sum of random Fourier modes with the same spectral envelope
    as the old global-FFT formulation (``k^(-5/6)`` amplitudes,
    ``|k| < 0.4`` cycles/sample) — but each mode is a plain cosine, so
    any vid range evaluates from O(modes * chunk) work with no
    full-field materialization.  All rng draws happen up front and do
    not depend on [lo, hi), and the mode loop accumulates elementwise in
    a fixed order, so chunk evaluation is bit-equal to full-field
    slices."""
    nx, ny, nz = g.dims
    # random directions on the sphere, band-limited magnitudes, and
    # k^(-5/6)-envelope amplitudes with random signs/phases
    dirs = rng.standard_normal((_PRESSURE_MODES, 3))
    dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
    kmag = rng.uniform(0.02, 0.4, _PRESSURE_MODES)
    amp = rng.standard_normal(_PRESSURE_MODES) * kmag ** (-5.0 / 6.0)
    phase = rng.uniform(0.0, 2 * np.pi, _PRESSURE_MODES)
    k = 2 * np.pi * dirs * kmag[:, None]     # radians per grid sample
    v = np.arange(lo, hi)
    x = (v % nx).astype(np.float64)
    y = ((v // nx) % ny).astype(np.float64)
    z = (v // (nx * ny)).astype(np.float64)
    f = np.zeros(hi - lo)
    for m in range(_PRESSURE_MODES):
        f += amp[m] * np.cos(k[m, 0] * x + k[m, 1] * y + k[m, 2] * z
                             + phase[m])
    return (f / np.sqrt(_PRESSURE_MODES)).astype(np.float32)


_RANGE_FIELDS: Dict[str, Callable] = {
    "elevation": _elevation, "wavelet": _wavelet, "random": _random,
    "isabel": _isabel, "backpack": _backpack, "magnetic": _magnetic,
    "truss": _truss, "pressure": _pressure,
}


# public full-field forms (legacy signature: field(g, rng) -> (nv,) float32)

def _full(name: str) -> Callable:
    def field(g: Grid, rng):
        return _RANGE_FIELDS[name](g, rng, 0, g.nv)
    field.__name__ = name
    return field


elevation = _full("elevation")
wavelet = _full("wavelet")
random = _full("random")
isabel = _full("isabel")
backpack = _full("backpack")
magnetic = _full("magnetic")
truss = _full("truss")
pressure = _full("pressure")

FIELDS: Dict[str, Callable] = {
    "elevation": elevation, "wavelet": wavelet, "random": random,
    "isabel": isabel, "backpack": backpack, "magnetic": magnetic,
    "truss": truss, "pressure": pressure,
}


def make_field(name: str, dims, seed: int = 0) -> np.ndarray:
    g = Grid.of(*dims)
    rng = np.random.default_rng(seed)
    return FIELDS[name](g, rng)


def make_field_chunk(name: str, dims, seed: int, zlo: int,
                     zhi: int) -> np.ndarray:
    """z-planes [zlo, zhi) of ``make_field(name, dims, seed)``, bit-exact.

    Returns a (zhi - zlo, ny, nx) float32 volume computed from O(chunk)
    memory, for every field.  This is the seekable generator behind
    ``repro.stream.FunctionSource.synthetic``."""
    g = Grid.of(*dims)
    nx, ny, nz = g.dims
    if not (0 <= zlo < zhi <= nz):
        raise IndexError(f"slab [{zlo}, {zhi}) out of range for nz={nz}")
    rng = np.random.default_rng(seed)
    plane = nx * ny
    out = _RANGE_FIELDS[name](g, rng, zlo * plane, zhi * plane)
    return out.reshape(zhi - zlo, ny, nx)
