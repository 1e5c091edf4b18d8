"""stage1_ms.plate: the program's ``device_stage1`` stage, ms a well: stage
1 on the card under the device lock, ending in the copy of its results to
the host (with ``-w``, the well-mask fit inside it)."""


def read(run):
    wells = run.driver.counters.get("wells")
    if run.driver.kind != "plate" or not wells:
        return None
    return run.timer.total("device_stage1") / wells * 1e3
