"""mirror_fetch_s: the device time of a job's fetches of mirrored blocks
from another card in the tiled finalize: the program's ``tile2d.mirror``
spans (a CUDA event pair on the fetching slot's stream, from the fetch's
start until its blocks have arrived) summed over the window, over the
window's jobs. None where the window made no such fetch."""


def read(run):
    total = run.hist_sums.get("tile2d.mirror")
    if not run.jobs or not total:
        return None
    return total / len(run.jobs)
