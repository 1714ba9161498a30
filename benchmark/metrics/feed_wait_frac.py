"""feed_wait_frac: the share of the gram phase in which the gram loop
waited on the feed: the program's ``prefetch.get_wait_s`` summed over
the window, over the summed ``gram`` phases."""


def read(run):
    gram = run.phase_total("gram")
    if gram <= 0 or "prefetch.get_wait_s" not in run.hist_sums:
        return None
    return run.hist_sums["prefetch.get_wait_s"] / gram
