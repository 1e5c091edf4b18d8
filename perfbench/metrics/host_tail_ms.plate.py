"""host_tail_ms.plate: the plate's host tail, ms a well: the program's
``post_filter`` and ``morse_graphs`` stages (the component filter and the
Morse engine), summed over the window's pool threads (work, not a share of
elapsed time)."""


def read(run):
    wells = run.driver.counters.get("wells")
    if run.driver.kind != "plate" or not wells:
        return None
    return run.timer.total("post_filter", "morse_graphs") / wells * 1e3
