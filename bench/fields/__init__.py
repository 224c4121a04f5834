"""The benchmark's field generators, one formula a file:
``bench/fields/<formula>.py`` with ``make(dims, seed, index, layout,
device, **params)``, which returns a flat float32 field made on
``device`` from ``(seed, index)`` and a layout number.  A configuration
names its formula under ``field.formula``; the other keys of ``field``
are the formula's parameters."""

from __future__ import annotations

_MASK = (1 << 64) - 1


def request_seed(seed: int, index: int) -> int:
    """One 64-bit generator seed per (run seed, request index)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (int(index) + 1)
         * 0xBF58476D1CE4E5B9) & _MASK
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK


def make(field: dict, dims, seed: int, index: int, layout: int, device):
    """The field of request ``index`` of a run with ``seed``, for a
    configuration's ``field`` entry."""
    from bench import found
    params = {k: v for k, v in field.items() if k != "formula"}
    return found.load("fields", field["formula"]).make(
        tuple(int(d) for d in dims), seed, index, layout, device, **params)
