"""down_block_roofline: the down block's least time (``work.block_work`` at
each call's shapes) over the device time of the kernels launched inside
the harness's spans (marker kernels) around ``down_block`` as ``models/unet.py`` binds it,
found by their place between the spans' markers on the device's timeline (``trace.py``), %."""


def read(run):
    ts, bound = run.trace_summary, run.driver.traced.get("down_block_bound_s")
    if ts is None or not bound:
        return None
    secs = ts.span_device_s(run.driver.spans, "down_block")
    return bound / secs * 100 if secs else None
