"""feed_copy_s: the device time of a job's host-to-device block copies:
the program's ``feed.copy`` spans (a CUDA event pair on the feed's copy
stream a block) summed over the window, over the window's jobs."""


def read(run):
    if not run.jobs or "feed.copy" not in run.hist_sums:
        return None
    return run.hist_sums["feed.copy"] / len(run.jobs)
