"""Find a piece of the benchmark by its name: ``load(kind, name)`` is the
module ``bench/<kind>/<name>.py``.  Configurations name their field's
formula (``fields``), traffic mixes their check (``checks``) and
``BENCHMARK.json`` its per-layer metrics (``metrics``); a later cell adds
such a file and its entries, and no file that is already here changes.
A name may hold dots (``idle_share.diagram``)."""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py``, loaded once per process."""
    key = f"bench._found.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is "
                                f"missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
