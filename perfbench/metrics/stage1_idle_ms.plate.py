"""stage1_idle_ms.plate: time inside the program's traced ``device_stage1``
spans (stage 1 under the device lock, ``tools/plate_pipeline.py``) in which
no kernel, copy or set ran on the card, ms a traced well: the spans mapped
onto the device's timeline through the trace's tie (``spans.py``)."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "plate" or not spans:
        return None
    wells = len(sp.named(spans, "well"))
    idle = sp.idle_s(run.trace_summary, sp.named(spans, "device_stage1"))
    return idle / wells * 1e3 if wells and idle is not None else None
