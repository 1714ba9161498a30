"""k1_launch_ms: K1's device time a launch, in ms: the program's
``kernel.packed_gram.launch`` spans (a CUDA event pair around each
launch) summed over the window, over the window's
``kernel.packed_gram.launches``."""


def read(run):
    launches = run.counters.get("kernel.packed_gram.launches", 0.0)
    if (not run.jobs or launches <= 0
            or "kernel.packed_gram.launch" not in run.hist_sums):
        return None
    return 1000.0 * run.hist_sums["kernel.packed_gram.launch"] / launches
