"""device_idle_pct.sync: the share of the window (synchronous products) in
which the device ran nothing, in %: 1 - (device busy time per product in
the profiled span x the window's products) / the window's seconds. The
busy time comes from the device trace; the window itself runs untraced, so
the profiler's host cost per launch stays out of the share."""


def read(run):
    t, w = run.trace, run.window
    if t is None or t.busy_s <= 0 or not (run.traffic["op"] == "product" and run.traffic["sync_each"]):
        return None
    return 100.0 * (1.0 - t.busy_s / t.ops * w.attempted / w.seconds)
