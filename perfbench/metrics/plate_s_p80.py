"""plate_s_p80: the 80th percentile of the wall time of each plate's
``run_plate`` call over all plates of the window (host clock), seconds:
with 50 plates or more, ten lie beyond it."""

import statistics


def read(run):
    if run.driver.kind != "plate" or len(run.driver.item_s) < 5:
        return None
    return statistics.quantiles(run.driver.item_s, n=5, method="inclusive")[3]
