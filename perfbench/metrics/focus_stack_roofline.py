"""focus_stack_roofline: the focus-stacking kernel's share of its roofline
over the traced plates, %: the least time of each traced well's
projection (``work.focus_work`` of one stack of the well's depth in
``run_plate.z_counts``, at the traffic's size and the plates' type) over
the device time of the ``focus_stack_kernel`` launches in the trace."""

from perfbench.work import focus_work


def read(run):
    ts, t = run.trace_summary, run.traffic
    kw = t.get("run_plate", {})
    if ts is None or run.driver.kind != "plate" or kw.get("proj_method") != "fs":
        return None
    secs = sum(b - a for a, b, name, _ in ts.device if "focus_stack_kernel" in name) / 1e6
    first, n = t["trace_plates"]
    plates = max(0, min(n, run.driver.counters.get("plates", 0) - first))
    depths = kw.get("z_counts") or [t["z"]] * t["wells_per_plate"]
    itemsize = run.driver.plates[0].dtype.itemsize
    bound = plates * sum(focus_work([z], t["size"], t["size"], itemsize)["bound_s"] for z in depths)
    return bound / secs * 100 if secs and bound else None
