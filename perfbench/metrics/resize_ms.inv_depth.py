"""resize_ms.inv_depth: the program's ``host_resize`` span in
``tools/compute_inv_depth.py``, the Lanczos-4 resize of a stack (the raw
stack's upload and the ``ops/resize_lanczos4.py`` kernel's launch), ms a
traced stack."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "inv_depth" or not spans:
        return None
    mine = sp.named(spans, "host_resize")
    return sp.host_s(mine) / len(mine) * 1e3 if mine else None
