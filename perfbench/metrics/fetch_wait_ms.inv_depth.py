"""fetch_wait_ms.inv_depth: the program's ``fetch_wait`` span in
``tools/compute_inv_depth.py``, the host blocked in the copy of a stack's
probabilities back (``yhat.cpu()``), ms a traced stack."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "inv_depth" or not spans:
        return None
    mine = sp.named(spans, "fetch_wait")
    return sp.host_s(mine) / len(mine) * 1e3 if mine else None
