"""The benchmark's field generator: the same (seed, index) gives the
same field, another gives another."""

import pytest
import torch

from bench import fields, found


def isabel(dims, seed, index, layout, device, **kw):
    return found.load("fields", "isabel").make(dims, seed, index, layout,
                                                device, **kw)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 99, 2**40 + 3])
def test_same_seed_same_field(seed):
    a = isabel((12, 10, 8), seed, 3, 5, "cpu")
    b = isabel((12, 10, 8), seed, 3, 5, "cpu")
    assert a.dtype == torch.float32 and a.shape == (960,)
    assert torch.equal(a, b)


def test_index_seed_and_layout_change_the_field():
    base = isabel((8, 8, 8), 5, 0, 0, "cpu")
    for other in ((5, 1, 0), (6, 0, 0), (5, 0, 1)):
        assert not torch.equal(base, isabel((8, 8, 8), *other, "cpu"))


def test_layout_alone_sets_the_blobs():
    a = isabel((16, 16, 16), 1, 0, 3, "cpu", noise=0.0)
    b = isabel((16, 16, 16), 2, 7, 3, "cpu", noise=0.0)
    assert torch.equal(a, b)
    assert a.min() >= 0 and 0.1 < a.max() < 6.0


@pytest.mark.cuda
def test_same_field_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = isabel((64, 64, 64), 7, 0, 1, "cuda")
    assert a.is_cuda and torch.equal(a, isabel((64, 64, 64), 7, 0, 1,
                                                      "cuda"))


def test_make_reads_the_configuration_entry():
    entry = {"formula": "isabel", "blobs": 4, "noise": 0.02}
    assert torch.equal(fields.make(entry, [10, 8, 6], 3, 1, 2, "cpu"),
                       isabel((10, 8, 6), 3, 1, 2, "cpu", noise=0.02))
