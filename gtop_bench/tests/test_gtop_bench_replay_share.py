"""``replan.search_replay_share`` on synthetic span records: no reading
without spans or without the search's graph counters, and the stated
share where the spans hold them.

    python -m pytest gtop_bench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT]

from gtop_bench import spec  # noqa: E402
from grad_traj_optimization_torch.utils import profiling  # noqa: E402

READ = spec.reader("replan.search_replay_share")


def _span(i, name, counts):
    return profiling.Span(name, 10 * i, 10 * i + 5, i, None, i, counts)


@pytest.fixture
def records(monkeypatch):
    """Span records put in the tracer's place for one test."""
    def put(spans):
        monkeypatch.setattr(profiling.TRACER, "records", spans)
    return put


def test_no_spans_read_none(records):
    records([])
    assert READ(None) is None
    # spans of a program whose search counts no graph: nothing to read
    records([_span(1, "replan.search", {"sync.replan.reached": 1}),
             _span(2, "replan.tick", {})])
    assert READ(None) is None


def test_share_of_replayed_searches(records):
    records([
        # a shape's first call: eager, nothing counted
        _span(1, "replan.search", {}),
        # its second: a capture and a replay
        _span(2, "replan.search", {"search.graph_captures": 1,
                                   "search.graph_replays": 1}),
        _span(3, "replan.search", {"search.graph_replays": 1}),
        _span(4, "replan.search", {"search.graph_replays": 1}),
        # other spans' counts are not read
        _span(5, "replan.tick", {"search.graph_replays": 7}),
    ])
    assert READ(None) == pytest.approx(75.0)
