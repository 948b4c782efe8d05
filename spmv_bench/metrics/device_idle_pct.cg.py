"""device_idle_pct.cg: the share of the window (whole CG solves) in which
the device ran nothing, in %: 1 - (device busy time per CG iteration in the
profiled solve x the window's iterations) / the window's seconds. The busy
time comes from the device trace; the window itself runs untraced, so the
profiler's host cost per launch stays out of the share."""


def read(run):
    t, w = run.trace, run.window
    if t is None or t.busy_s <= 0 or t.ops <= 0 or run.traffic["op"] != "solve":
        return None
    return 100.0 * (1.0 - t.busy_s / t.ops * int(w.iters.sum()) / w.seconds)
