"""eigh_chase_s: the subset solve's second stage a job, band to
tridiagonal by the bulge-chasing kernel (``ops/band_chase.py::chase``):
the program's ``eigh.chase`` spans summed over the window, over the
window's jobs. It lies inside ``eigh.solve``. None where the program has
no such span (a solve that does not reduce in two stages)."""


def read(run):
    if not run.jobs or "eigh.chase" not in run.hist_sums:
        return None
    return run.hist_sums["eigh.chase"] / len(run.jobs)
