"""pairs_per_s: every pair that a call of the window completed, over the
window: from the first call's entry to the end of the last call's
synchronise (host clock).  Each call that started inside the window is
counted whole; a call's pairs are the traffic's work a call."""


def read(run):
    return run["calls"] * run["work_per_call"] / run["window_s"]
