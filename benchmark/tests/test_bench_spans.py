"""The untraced run, which gives every end-to-end number, leaves the
program's spans off: nothing enables them and nothing is stored."""

import pytest

from benchmark.tests import tiny
from cloth_splatting_tpu_torch.utils import profiling


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_untraced_run_never_enables_spans(cell, monkeypatch):
    def refuse(on=True):
        raise AssertionError("an untraced run enabled the program's spans")

    profiling.take_spans()
    monkeypatch.setattr(profiling, "enable_spans", refuse)
    r = tiny.run_cpu(cell, seconds=0.3)
    assert r["attempted"] > 0
    assert profiling.span("forward") is profiling.span("backward")
    assert profiling.take_spans() == []
