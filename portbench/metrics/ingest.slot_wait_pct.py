"""The share of the window in which the producer threads waited for a
free chunk slot: each bank's Timeline ``ingest.slot_wait`` seconds
over the window, the mean of the banks (0 for a bank that never
waited), in percent.  None where the program times no such stage."""

NAME = "ingest.slot_wait"


def read(run):
    if run.window_s <= 0 or not any(NAME in b["stages"] for b in run.banks):
        return None
    shares = [b["stages"].get(NAME, {}).get("seconds", 0.0) / run.window_s
              for b in run.banks]
    return 100.0 * sum(shares) / len(shares)
