"""product_device_us: the summed time of the device operations in the
profiled span / the products in it (device trace)."""


def read(run):
    t = run.trace
    if t is None or run.traffic["op"] != "product" or t.device_s <= 0:
        return None
    return t.device_s * 1e6 / t.ops
