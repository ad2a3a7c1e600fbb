"""qps: every query answered in the window over the window's seconds (host clock)."""


def read(run):
    return run.queries / run.window_s
