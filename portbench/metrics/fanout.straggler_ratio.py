"""The band fan-out's balance: the banks' mean rate over the slowest
bank's, each bank's rate its finished RAW bytes over the time from the
window's start to its own product's end (1 when the card serves the
banks evenly)."""


def read(run):
    rates = [b["bytes"] / b["seconds"] for b in run.banks if b["seconds"] > 0]
    if not rates or min(rates) <= 0:
        return None
    return sum(rates) / len(rates) / min(rates)
