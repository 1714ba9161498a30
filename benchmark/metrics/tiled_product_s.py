"""tiled_product_s: the device time of a job's ``B @ Q`` products in the
tiled eigensolve (each tile's product on its card and their sum on the
first): the program's ``eigh.tiled_product`` spans summed over the
window, over the window's jobs. None where the window ran no tiled
solve."""


def read(run):
    total = run.hist_sums.get("eigh.tiled_product")
    if not run.jobs or not total:
        return None
    return total / len(run.jobs)
