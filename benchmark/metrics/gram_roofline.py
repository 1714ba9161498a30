"""gram_roofline: the least time one card needs for the window's gram
work (``benchmark/roofline.py``) as a share, in %, of the device time
of the kernels inside the program's ``phase.gram`` ranges, summed over
the cell's cards: the same work whatever kernel does it."""

from benchmark import roofline


def read(run):
    metric = run.mix.get("metric")
    if run.trace is None or metric not in roofline.PRODUCTS:
        return None
    kernel_s = run.trace["phase_kernel_s"].get("gram", 0.0)
    if kernel_s <= 0:
        return None
    bound = roofline.gram_bound_s(metric, int(run.config["n_samples"]),
                                  int(run.config["n_variants"]))
    return 100.0 * bound * len(run.jobs) / kernel_s
