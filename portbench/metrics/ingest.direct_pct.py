"""The share of the producers' input bytes that the card read straight
from the recorder's RAM blocks: each bank's Timeline ``ingest.direct``
bytes over its ``ingest.direct`` and ``ingest`` bytes (the blocks the
producer read on the host), the banks summed, in percent.  None where no
bank has ``ingest.direct`` (a program without the direct path, or one
in which it never engaged)."""


def read(run):
    stages = [b["stages"] for b in run.banks]
    if not any("ingest.direct" in s for s in stages):
        return None
    direct = sum(s.get("ingest.direct", {}).get("bytes", 0) for s in stages)
    host = sum(s.get("ingest", {}).get("bytes", 0) for s in stages)
    if direct + host <= 0:
        return None
    return 100.0 * direct / (direct + host)
