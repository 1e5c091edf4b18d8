"""host_resize_ms: the harness's host-clock span around the Lanczos-4
``host_resize`` that ``compute_inv_depth.dispatch_stack`` calls, ms a
stack, with no synchronise."""


def read(run):
    stacks = run.driver.counters.get("stacks")
    if not stacks or "host_resize" not in run.timer.totals:
        return None
    return run.timer.total("host_resize") / run.timer.counts["host_resize"] * 1e3
