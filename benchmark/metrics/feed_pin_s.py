"""feed_pin_s: the feed producer's copies of a job's blocks into the
pinned staging slabs: the program's ``feed.pin`` spans summed over the
window, over the window's jobs."""


def read(run):
    if not run.jobs or "feed.pin" not in run.hist_sums:
        return None
    return run.hist_sums["feed.pin"] / len(run.jobs)
