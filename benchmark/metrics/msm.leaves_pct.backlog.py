"""msm.leaves_pct.backlog: the share of the MSMs' sum-tree leaves that the
window's full slices planned, against the full tables', 100 x msm_leaves /
msm_leaves_full from the program's step.finalize records (a slice whose
voters all lie above the cut depth runs on tables without the SMT levels
below it).  A program that records neither count gives None."""


def read(run):
    if run.window.loop != "closed":
        return None
    full = [r for r in run.records
            if r["kind"] == "span" and r["name"] == "step.finalize"
            and r["batch"] == run.batch and "msm_leaves_full" in r]
    leaves = sum(r["msm_leaves_full"] for r in full)
    return 100 * sum(r["msm_leaves"] for r in full) / leaves if leaves \
        else None
