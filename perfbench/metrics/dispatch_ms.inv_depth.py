"""dispatch_ms.inv_depth: the program's ``dispatch`` span in
``tools/compute_inv_depth.py``, the upload, the prep tail and the members'
forwards as the host enqueues them (no synchronise), ms a traced stack."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "inv_depth" or not spans:
        return None
    mine = sp.named(spans, "dispatch")
    return sp.host_s(mine) / len(mine) * 1e3 if mine else None
