"""The per-layer metrics read from the program's span counters, on the
CPU copy of a cell: each is read, and together they account for no more
than the calls they split."""

import numpy as np
import pytest
import tinycell

from benchmark import harness
from benchmark.spec import Cell

SEED = 2**31 + 777
SPAN_METRICS = ("frontend.host_ms", "executor.plan_ms", "program.key_ms", "program.host_ms",
                "program.wait_ms")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    names = tinycell.make(root)
    names["dir"] = root
    return names


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
def test_span_metrics_split_the_mean_call(tiny, kind, monkeypatch):
    seen = {}
    reader = Cell.reader

    def spying(self, metric):
        read = reader(self, metric)

        def spy(obs):
            seen["obs"] = obs
            return read(obs)

        return spy

    # the observation the harness hands its readers
    monkeypatch.setattr(Cell, "reader", spying)
    out = harness.run_cell(tiny[kind], SEED, 0.5, False, device="cpu", bench_dir=tiny["dir"],
                           manifest=tiny["manifest"])
    assert out["result"]["correct"]
    obs = seen["obs"]
    window = obs["counters"]
    assert obs["searches"] > 0
    for s in ("table.search", "vector_search", "program.key", "program.run", "program.load",
              "result.readback", "table.gather"):
        assert window[f"{s}.calls"] == obs["searches"], s
    assert window.get("SearchProgramCaptures", 0) == 0
    cell = Cell(tiny[kind], tiny["dir"], tiny["manifest"])
    got = {m: reader(cell, m)(obs) for m in SPAN_METRICS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    mean_call_ms = 1e3 * float(np.mean(obs["latencies_s"]))
    assert 0 < sum(got.values()) <= mean_call_ms, (got, mean_call_ms)


def test_span_metrics_read_nothing_without_the_spans(tiny):
    """A version of the program that counts no spans gives no value, and
    no error."""
    cell = Cell(tiny["exact"], tiny["dir"], tiny["manifest"])
    for obs in ({"counters": {"SearchProgramCaptures": 0}, "searches": 10},
                {"counters": {}, "searches": 0}):
        assert all(cell.reader(m)(obs) is None for m in SPAN_METRICS)
