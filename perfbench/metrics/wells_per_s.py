"""wells_per_s: wells of every plate started in the window, over the time
from the window's start to the end of the last of those plates (host clock)."""


def read(run):
    c = run.driver.counters
    return c["wells"] / run.window_s if "wells" in c and run.window_s else None
