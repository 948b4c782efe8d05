"""prepare_s: seconds of AutoSpMV.from_csr (host clock, synchronized),
part of setup_s."""


def read(run):
    return run.prepare_s
