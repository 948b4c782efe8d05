"""spmv_roofline: the least time of a product / its device time
(product_device_us), in %. The least time counts the matrix's own bytes
and operations (roofline.py), whatever layout the program prepares."""

from spmv_bench import roofline


def read(run):
    t = run.trace
    if t is None or run.traffic["op"] != "product" or t.device_s <= 0:
        return None
    m, n = run.shape
    least = roofline.least_time_s(m, n, run.nnz, run.config["dtype"])
    return 100.0 * least / (t.device_s / t.ops)
