"""cg_iter_us: the window's microseconds / all the iterations of its
solves (host clock)."""


def read(run):
    it = run.window.iters
    if it is None or int(it.sum()) <= 0:
        return None
    return run.window.seconds * 1e6 / int(it.sum())
