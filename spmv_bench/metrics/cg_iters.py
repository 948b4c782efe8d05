"""cg_iters: CG iterations per solve, the mean of CGResult.iters over the
window's solves (the program's counter)."""


def read(run):
    if run.window.iters is None or not len(run.window.iters):
        return None
    return float(run.window.iters.mean())
