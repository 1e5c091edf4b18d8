"""well_mask_ms.plate: the program's ``well_mask`` stage (the well-mask fit
of ``run_plate``'s ``detect_well``: the resize to the segmentor's scale,
its copy to the host and ``make_well_mask``, under the device lock inside
``device_stage1``), ms a well over the window; None where no well is fitted."""


def read(run):
    wells = run.driver.counters.get("wells")
    if run.driver.kind != "plate" or not wells or "well_mask" not in run.timer.totals:
        return None
    return run.timer.total("well_mask") / wells * 1e3
