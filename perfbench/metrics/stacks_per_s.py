"""stacks_per_s: stacks whose rows came back, over the time from the first
stack handed to ``predict_rows`` to its return (host clock)."""


def read(run):
    c = run.driver.counters
    return c["stacks"] / run.window_s if "stacks" in c and run.window_s else None
