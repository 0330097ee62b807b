"""The readers of the program's wait stages, on hand-built runs with known
Timeline stage tables, and in a traced CPU rehearsal."""

import pytest

from conftest import REPO  # noqa: F401  (puts the repo on the path)
from portbench import harness

WAIT_METRICS = ("ingest.slot_wait_pct", "dispatch.chunk_wait_pct",
                "dispatch.put_wait_pct")


def read(name, run):
    return harness.plugin("metrics", name).read(run)


def bank(**seconds):
    """A bank's stage table: ``ingest_slot_wait=0.5`` is the stage
    ``ingest.slot_wait`` at 0.5 s."""
    return {"bytes": 0, "seconds": 0.1,
            "stages": {k.replace("_", ".", 1): {"seconds": v, "bytes": 0,
                                                "calls": 1}
                       for k, v in seconds.items()}}


def two_banks():
    """Two banks over a 100 ms window."""
    run = harness.Run()
    run.window_s = 0.1
    run.banks = [bank(ingest=0.095, ingest_slot_wait=0.005,
                      dispatch_chunk_wait=0.065, dispatch_put_wait=0.0),
                 bank(ingest=0.085, ingest_slot_wait=0.015,
                      dispatch_chunk_wait=0.065, dispatch_put_wait=0.014)]
    return run


def test_the_wait_shares_are_the_means_of_the_banks():
    run = two_banks()
    assert read("ingest.slot_wait_pct", run) == pytest.approx((5 + 15) / 2)
    assert read("dispatch.chunk_wait_pct", run) == pytest.approx(65.0)
    assert read("dispatch.put_wait_pct", run) == pytest.approx(14 / 2)


def test_a_bank_that_never_waited_reads_zero():
    run = two_banks()
    del run.banks[0]["stages"]["dispatch.put_wait"]
    assert read("dispatch.put_wait_pct", run) == pytest.approx(14 / 2)


@pytest.mark.parametrize("metric", WAIT_METRICS)
def test_a_program_without_the_wait_stages_reads_none(metric):
    run = two_banks()
    for b in run.banks:
        b["stages"] = {"ingest": b["stages"]["ingest"]}
    assert read(metric, run) is None
    run = two_banks()
    run.window_s = 0.0
    assert read(metric, run) is None


def test_a_traced_cpu_rehearsal_reports_the_wait_shares(tree):
    from conftest import rehearse

    rc, last, err = rehearse(tree, "tiny.0002", trace=True)
    assert rc == 0, err
    got = last["metrics"]
    for m in WAIT_METRICS:
        assert 0.0 <= got[m]["value"] <= 100.0 and got[m]["unit"] == "%"
