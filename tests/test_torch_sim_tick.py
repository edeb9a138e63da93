"""The port's simulator against the reference's on ``day-600`` under the
tick engine, for each of the five policies: metrics, per-job outcomes and
the event log equal (``test_torch_sim.py`` holds the rest). Each replay
walks the day in the scheduler bench's 2 s ticks, a few seconds a side, so
these cases have a file of their own."""
import pytest

pytest.importorskip("torch")

from test_torch_sim import POLICIES, check_day600


@pytest.mark.parametrize("policy", POLICIES)
def test_day600_tick_engine_equals_reference(policy, tmp_path):
    check_day600(policy, "tick", tmp_path)
