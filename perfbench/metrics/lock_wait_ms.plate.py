"""lock_wait_ms.plate: the program's ``device_lock_wait`` spans (a pool
thread's wait for the device lock, before stage 1 and before stage 2),
summed over a traced well's two acquisitions, ms a traced well."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "plate" or not spans:
        return None
    wells = len(sp.named(spans, "well"))
    return sp.host_s(sp.named(spans, "device_lock_wait")) / wells * 1e3 if wells else None
