"""feed_read_s: the feed producer's host work for the blocks of a job:
the program's ``feed.read`` spans (the source's slice and copy of each
block, or its decode into the feed's buffer) summed over the window,
over the window's jobs."""


def read(run):
    if not run.jobs or "feed.read" not in run.hist_sums:
        return None
    return run.hist_sums["feed.read"] / len(run.jobs)
