"""spmv_gflops: 2 nnz x the products the window completed / the window's
seconds (host clock, the window closed by a synchronize), in GFLOP/s."""


def read(run):
    if run.traffic["op"] != "product":
        return None
    return 2 * run.nnz * run.window.attempted / run.window.seconds / 1e9
