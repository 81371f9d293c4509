"""witness.smt_hashed_pct.backlog: the share of the SMT levels that the
witness hashed over the window's full slices, 100 x smt_hashed /
smt_levels from the program's step.finalize records (the levels at or
below each voter's leaf come from a table instead).  A program that
records no such count gives None."""


def read(run):
    if run.window.loop != "closed":
        return None
    full = [r for r in run.records
            if r["kind"] == "span" and r["name"] == "step.finalize"
            and r["batch"] == run.batch and "smt_hashed" in r]
    levels = sum(r["smt_levels"] for r in full)
    return 100 * sum(r["smt_hashed"] for r in full) / levels if levels \
        else None
