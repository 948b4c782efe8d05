"""kernels_per_product: the kernels the device ran in the profiled span /
the products in it (device trace; copies and fills not counted)."""


def read(run):
    t = run.trace
    if t is None or run.traffic["op"] != "product" or not t.kernels:
        return None
    return t.kernels / t.ops
