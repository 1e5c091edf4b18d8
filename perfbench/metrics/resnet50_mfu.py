"""resnet50_mfu: the ensemble forwards' share of the card's bf16 peak over
the traced part of the window, %: the operations of the stacks handed in
(``work.resnet50_layers`` for each slice and member) over the traced
window's length times 989 TFLOP/s."""

from perfbench.work import PEAK_BF16_TC


def read(run):
    ts, flops = run.trace_summary, run.driver.traced.get("resnet_flops")
    if ts is None or not flops:
        return None
    return flops / (ts.window_s * PEAK_BF16_TC) * 100
