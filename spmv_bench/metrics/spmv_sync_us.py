"""spmv_sync_us: the window's microseconds / its products, each a call
followed by a synchronize (host clock over the whole window): what a
caller who waits for every y pays per product."""


def read(run):
    if run.traffic["op"] != "product" or not run.traffic["sync_each"]:
        return None
    return run.window.seconds * 1e6 / run.window.attempted
