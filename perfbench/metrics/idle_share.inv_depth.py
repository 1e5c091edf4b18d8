"""idle_share.inv_depth: the share of the traced window in which no kernel, copy
or set ran on the card, %: one minus the union of their intervals over
the traced window's wall time."""


def read(run):
    ts = run.trace_summary
    if ts is None or run.driver.kind != "inv_depth" or ts.window_s <= 0:
        return None
    return (1 - ts.busy_s / ts.window_s) * 100
