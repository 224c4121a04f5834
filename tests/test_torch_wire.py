"""PyTorch port, DDMS v1 wire format: ``DiagramResult.to_bytes`` /
``from_bytes`` of ``repro_torch.pipeline`` against the JAX package's.

Port payloads are byte-identical to the reference's for the same request,
in memory and streamed; each package decodes the other's payload and
answers ``pairs``, ``essential`` and ``betti`` the same; unknown arrays
survive decoding; a bad magic, a newer version and trailing bytes are
refused."""

import struct

import numpy as np
import pytest

from repro.core import grid as JG
from repro.pipeline import PersistencePipeline as JPipeline
from repro.pipeline import TopoRequest as JRequest
from repro.pipeline.result import WIRE_MAGIC as J_MAGIC
from repro.pipeline.result import WIRE_VERSION as J_VERSION
from repro.pipeline.result import DiagramResult as JResult
from repro.stream import ArraySource as JArraySource

from repro_torch.core.grid import Grid
from repro_torch.fields.generators import make_field
from repro_torch.pipeline import (WIRE_MAGIC, WIRE_VERSION, DiagramResult,
                                  PersistencePipeline, TopoRequest)
from repro_torch.stream import ArraySource

QUERY = dict(min_persistence=0.05, top_k=7)


def _pair(name, dims, streamed=False, **req):
    """(port result, reference result) of one request."""
    f = make_field(name, dims, seed=2)
    if streamed:
        v = f.reshape(Grid.of(*dims).dims[::-1])
        port = PersistencePipeline(device="cpu").run(
            TopoRequest(field=ArraySource(v), chunk_z=3, **req))
        ref = JPipeline(backend="jax").run(
            JRequest(field=JArraySource(v), chunk_z=3, **req))
    else:
        port = PersistencePipeline(device="cpu").run(
            TopoRequest(field=f, grid=Grid.of(*dims), **req))
        ref = JPipeline(backend="jax").run(
            JRequest(field=f, grid=JG.Grid.of(*dims), **req))
    return port, ref


def _assert_same_answers(a, b):
    assert a.homology_dims == b.homology_dims
    assert a.grid_dims == b.grid_dims
    assert a.betti() == b.betti()
    for p in a.homology_dims:
        for space in ("value", "order"):
            np.testing.assert_array_equal(a.pairs(p, space=space),
                                          b.pairs(p, space=space))
            np.testing.assert_array_equal(
                a.pairs(p, space=space, top_k=3, min_persistence=0.0),
                b.pairs(p, space=space, top_k=3, min_persistence=0.0))
            np.testing.assert_array_equal(a.essential(p, space=space),
                                          b.essential(p, space=space))


def test_wire_constants_match_reference():
    assert (WIRE_MAGIC, WIRE_VERSION) == (J_MAGIC, J_VERSION)


@pytest.mark.parametrize("name,dims,streamed,req", [
    ("random", (7, 6, 5), False, {}),
    ("isabel", (8, 5, 7), False, QUERY),
    ("wavelet", (9, 7, 1), False, {}),                   # 2-D
    ("random", (12, 1, 1), False, dict(top_k=2)),        # 1-D
    ("magnetic", (6, 5, 7), False, dict(homology_dims=(0, 2))),
    ("isabel", (9, 7, 12), True, {}),
    ("random", (6, 5, 8), True, QUERY)])
def test_payloads_match_reference_bytes(name, dims, streamed, req):
    port, ref = _pair(name, dims, streamed, **req)
    assert port.to_bytes() == ref.to_bytes()


@pytest.mark.parametrize("streamed", [False, True])
def test_payloads_cross_decode(streamed):
    port, ref = _pair("isabel", (8, 6, 9), streamed, **QUERY)
    from_port = JResult.from_bytes(port.to_bytes())
    from_ref = DiagramResult.from_bytes(ref.to_bytes())
    for decoded in (from_port, from_ref):
        _assert_same_answers(decoded, port)
        _assert_same_answers(decoded, ref)
    # the query defaults travel with the payload
    assert len(from_ref.pairs(0)) == len(port.pairs(0)) <= QUERY["top_k"]
    # a decoded payload re-encodes to the same bytes in both packages
    assert from_ref.to_bytes() == port.to_bytes() == from_port.to_bytes()


def test_unknown_arrays_survive_decoding():
    port, _ = _pair("random", (5, 4, 3))
    port.arrays()["x.future_array"] = np.arange(6, dtype="<i2").reshape(2, 3)
    payload = port.to_bytes()
    for cls in (DiagramResult, JResult):
        back = cls.from_bytes(payload)
        np.testing.assert_array_equal(back.arrays()["x.future_array"],
                                      np.arange(6).reshape(2, 3))
        assert back.arrays()["x.future_array"].dtype == np.dtype("<i2")
        assert back.to_bytes() == payload
    _assert_same_answers(DiagramResult.from_bytes(payload), port)


def test_malformed_payloads_are_refused():
    port, _ = _pair("random", (5, 4, 3))
    payload = port.to_bytes()
    with pytest.raises(ValueError, match="not a DDMS payload"):
        DiagramResult.from_bytes(b"XXXX" + payload[4:])
    newer = payload[:4] + struct.pack("<H", WIRE_VERSION + 1) + payload[6:]
    with pytest.raises(ValueError, match="newer"):
        DiagramResult.from_bytes(newer)
    with pytest.raises(ValueError, match="trailing bytes"):
        DiagramResult.from_bytes(payload + b"\0")
    decoded = DiagramResult.from_bytes(payload)
    assert decoded.diagram is None and decoded.grid_dims == (5, 4, 3)
    with pytest.raises(ValueError, match="not computed"):
        decoded.pairs(4)
