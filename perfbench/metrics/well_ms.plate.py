"""well_ms.plate: the median of the traced wells' ``well`` spans, ms: from
the producer's hand-off of the well to the end of its ``morse_graphs``
(the median, not a tail: 24 traced wells put too few beyond a tail)."""

import statistics

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "plate" or not spans:
        return None
    wells = [s.end - s.start for s in sp.named(spans, "well")]
    return statistics.median(wells) * 1e3 if wells else None
