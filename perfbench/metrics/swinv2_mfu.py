"""swinv2_mfu: the SwinV2 ensemble forwards' share of the card's bf16 peak
over the traced part of the window, %: the images the traced forwards took
(the program's counter ``attn_windows`` over its ``swin_forward`` spans,
over the windows one image makes, ``work_swinv2.windows_per_image``) times
one image's operations (``work_swinv2.swinv2_layers``), over the traced
window's length times 989 TFLOP/s."""

from perfbench import spans as sp
from perfbench.work import PEAK_BF16_TC
from perfbench.work_swinv2 import swinv2_flops, windows_per_image


def read(run):
    spans = sp.traced_spans(run)
    if run.driver.kind != "inv_depth" or not spans or "embed_dim" not in run.config:
        return None
    windows = sp.counted(sp.named(spans, "swin_forward"), "attn_windows")
    if not windows:
        return None
    images = windows / windows_per_image(run.config)
    return images * swinv2_flops(run.config) / (run.trace_summary.window_s * PEAK_BF16_TC) * 100
