"""device.idle_pct.backlog: the share of the traced stretch of full
slices in which no operation ran on the card, in %."""
from benchmark.harness import cell


def read(run):
    return cell.idle_pct(run, "closed")
