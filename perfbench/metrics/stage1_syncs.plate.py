"""stage1_syncs.plate: the host syncs of stage 1, a traced well: the
program's counters ``gmm_iters`` (one a GMM EM iteration,
``ops/threshold.py::gmm2_fit``), ``skeleton_passes`` (one a Zhang-Suen pass,
``ops/morphology.py::skeletonize``) and ``host_copies`` (the three copies of
its results back), as its traced ``device_stage1`` spans recorded them."""

from perfbench import spans as sp


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "plate" or not spans:
        return None
    wells = len(sp.named(spans, "well"))
    syncs = sp.counted(sp.named(spans, "device_stage1"), "gmm_iters", "skeleton_passes", "host_copies")
    return syncs / wells if wells else None
