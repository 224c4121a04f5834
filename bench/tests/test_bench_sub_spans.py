"""The readers of the program's sub-spans, steps and counter: each reads
its key from a stub run of its own kind, and nothing from a run of the
other kind or from one whose program reports no such key."""

import pytest

from bench import found

# reader -> (the kind of run it reads, the key it reads)
READERS = {"scatter_s": ("pipeline", "gradient.scatter"),
           "edge_keys_s": ("pipeline", "extract_sort.edge_keys"),
           "crit_select_s": ("pipeline", "extract_sort.select"),
           "d0_graph_s": ("pipeline", "d0.graph"),
           "d0_host_syncs": ("pipeline", "d0_host_syncs"),
           "gather_s.ring": ("ring", "gather"),
           "comm_exposed_s.ring": ("ring", "comm")}


def _ctx(kind, key):
    per_call = [{key: 1.0, "x": 5.0}, {key: 3.0}]
    if kind == "pipeline":
        return {"kind": "pipeline", "stats": per_call, "trace": None}
    return {"kind": "ring", "steps": per_call, "trace": None}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_own_kind_only(name):
    kind, key = READERS[name]
    read = found.load("metrics", name).read
    assert read(_ctx(kind, key)) == 2.0
    assert read(_ctx("ring" if kind == "pipeline" else "pipeline",
                     key)) is None
    assert read(_ctx(kind, "not_reported")) is None
