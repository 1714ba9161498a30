"""eigh_band_s: the subset solve's first stage a job, dense to band by
blocked FP32 products (``ops/eigh.py::dense_to_band``): the program's
``eigh.band`` spans summed over the window, over the window's jobs. It
lies inside ``eigh.solve``. None where the program has no such span (a
solve that does not reduce in two stages)."""


def read(run):
    if not run.jobs or "eigh.band" not in run.hist_sums:
        return None
    return run.hist_sums["eigh.band"] / len(run.jobs)
