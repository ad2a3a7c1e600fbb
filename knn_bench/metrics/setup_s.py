"""setup_s: process start to the first timed batch (host clock): imports,
the card's start, the kernel library's load (its build in a checkout's
first run), the data drawn, the index built and the cell's shapes warmed."""


def read(run):
    return run.setup_s
