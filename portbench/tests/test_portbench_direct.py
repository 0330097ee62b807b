"""The reader of ``ingest.direct_pct`` on hand-built runs with known
Timeline stage tables."""

import pytest

from conftest import REPO  # noqa: F401  (puts the repo on the path)
from portbench import harness


def read(run):
    return harness.plugin("metrics", "ingest.direct_pct").read(run)


def bank(**nbytes):
    """A bank's stage table: ``ingest_direct=5`` is the stage
    ``ingest.direct`` with 5 bytes."""
    return {"bytes": 0, "seconds": 0.1,
            "stages": {k.replace("_", ".", 1): {"seconds": 0.01, "bytes": v,
                                                "calls": 1}
                       for k, v in nbytes.items()}}


def run_of(*banks):
    run = harness.Run()
    run.window_s = 0.1
    run.banks = list(banks)
    return run


def test_the_share_sums_the_banks_bytes():
    run = run_of(bank(ingest_direct=1000),
                 bank(ingest=2000, ingest_direct=1000))
    assert read(run) == pytest.approx(100.0 * 2000 / 4000)


def test_a_bank_read_on_the_host_alone_reads_zero():
    run = run_of(bank(ingest=1000, ingest_direct=0), bank(ingest=1000))
    assert read(run) == 0.0


def test_a_window_read_in_place_alone_reads_a_hundred():
    assert read(run_of(bank(ingest_direct=10), bank(ingest_direct=30))) == 100.0


def test_a_program_without_the_direct_path_reads_none():
    assert read(run_of(bank(ingest=1000), bank(ingest=500))) is None
    assert read(run_of(bank(ingest_slot_wait=0))) is None
    assert read(run_of(bank(ingest_direct=0))) is None
    assert read(run_of()) is None
