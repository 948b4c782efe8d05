"""cg_solve_ms: the window's milliseconds / the solves it completed to
tolerance (host clock): what a solver's user waits for a solution."""


def read(run):
    w = run.window
    done = w.attempted - w.failed
    if run.traffic["op"] != "solve" or done <= 0:
        return None
    return w.seconds * 1e3 / done
