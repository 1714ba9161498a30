"""gram_gap_s: the seconds a job's gram loop left the compute stream
idle (before the first block update and between updates, CUDA events on
the stream): the program's ``gram.device_gap_s`` counter over the
window, over the window's jobs."""


def read(run):
    if not run.jobs or "gram.device_gap_s" not in run.counters:
        return None
    return run.counters["gram.device_gap_s"] / len(run.jobs)
