"""window_attn_roofline: the window attention's share of its roofline over
the traced stacks, %: the least time of the traced forwards' window
attention calls (``work_swinv2.attention_bound_s``: their QKᵀ and AV
products at the bf16 peak or their q, k, v, output and tables at the
card's bandwidth, whichever is longer) over the device time of all the
kernels of those calls: the q and k normalisations, the logit scale and
the fused attention kernel (``work_swinv2.attention_calls``, by name).

The program replays each member's features from a CUDA graph, whose
kernels share the graph launch's correlation in the trace, so no marker
can delimit a call inside it (``trace.py`` takes every kernel of a marker's
correlation for a marker); the calls are found by their first and last
kernels' names instead. The trace's first forward may have started before
it, so only whole forwards count: the last ``n × blocks`` calls found, n
as many as fit. The images a forward takes come from the program's
counters ``attn_calls`` and ``attn_windows`` of its ``swin_forward`` spans.
None without those spans (a program without SwinV2) or without a device
trace; a card's trace of such forwards in which no whole forward's calls
are found raises: the names in ``work_swinv2`` no longer match the
program's kernels."""

from perfbench import spans as sp
from perfbench.work_swinv2 import attention_bound_s, attention_calls, windows_per_image


def read(run):
    ts, c = run.trace_summary, run.config
    spans = sp.traced_spans(run)
    if ts is None or not spans or "embed_dim" not in c:
        return None
    forwards = sp.named(spans, "swin_forward")
    calls = sp.counted(forwards, "attn_calls")
    if not forwards or not calls or not ts.device:
        return None
    blocks = sum(c["depths"])
    batch = round(sp.counted(forwards, "attn_windows") * blocks / (calls * windows_per_image(c)))
    found = attention_calls(ts.device)
    whole = len(found) // blocks
    if not whole:
        raise RuntimeError(f"window_attn_roofline: {len(found)} window attention calls in the trace of "
                           f"{len(forwards)} swin_forward spans, not one forward's {blocks}: no kernel matched "
                           "work_swinv2.ATTN_FIRST_KERNELS / ATTN_LAST_KERNELS")
    secs = sum(found[len(found) - whole * blocks:])
    return whole * attention_bound_s(c, batch) / secs * 100
