"""device.idle_pct.arrivals: the share of the traced calls of
ProofStream.run in which no operation ran on the card, in %; waits for
arrivals between calls are not proving and are left out."""
from benchmark.harness import cell


def read(run):
    return cell.idle_pct(run, "open")
