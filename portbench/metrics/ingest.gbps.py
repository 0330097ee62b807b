"""The producers' copy rate: each bank's Timeline ``ingest`` stage
(the RAM to pinned-slot copies of the live feed) as bytes over its own
seconds, summed over the banks, in GB/s."""


def read(run):
    total, seen = 0.0, False
    for b in run.banks:
        st = b["stages"].get("ingest")
        if st and st["seconds"] > 0:
            total += st["bytes"] / st["seconds"] / 1e9
            seen = True
    return total if seen else None
