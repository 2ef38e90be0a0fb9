"""executor.plan_hit_share on the CPU copy of a cell: the window's
searches run the plan the warm-up kept, and a program that counts no plan
gives no value."""

import pytest
import tinycell

from benchmark import harness
from benchmark.spec import Cell

SEED = 2**31 + 2_027
METRIC = "executor.plan_hit_share"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    names = tinycell.make(root)
    names["dir"] = root
    return names


@pytest.mark.parametrize("kind", ["exact", "ivfflat"])
def test_the_window_runs_kept_plans(tiny, kind, monkeypatch):
    seen = {}
    reader = Cell.reader

    def spying(self, metric):
        read = reader(self, metric)

        def spy(obs):
            seen["obs"] = obs
            return read(obs)

        return spy

    monkeypatch.setattr(Cell, "reader", spying)
    out = harness.run_cell(tiny[kind], SEED, 0.5, False, device="cpu", bench_dir=tiny["dir"],
                           manifest=tiny["manifest"])
    assert out["result"]["correct"]
    cell = Cell(tiny[kind], tiny["dir"], tiny["manifest"])
    share = reader(cell, METRIC)(seen["obs"])
    assert share is not None and 90.0 < share <= 100.0, share


def test_reads_nothing_without_the_counters(tiny):
    cell = Cell(tiny["exact"], tiny["dir"], tiny["manifest"])
    for obs in ({"counters": {"SearchProgramCaptures": 0}, "searches": 10},
                {"counters": {"SearchPlanHits": 0, "SearchPlanMisses": 0}, "searches": 10},
                {"counters": {}, "searches": 0}):
        assert cell.reader(METRIC)(obs) is None
