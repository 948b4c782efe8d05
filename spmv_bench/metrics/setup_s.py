"""setup_s: seconds from the start of the process to the first timed
operation: the generation of the inputs, the program's prepare (and, in a
checkout's first run, its build) and the warm-up."""


def read(run):
    return run.setup_s
