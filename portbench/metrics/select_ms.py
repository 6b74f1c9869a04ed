"""`select_ms`: the median device ms of the dense lane's choice of the best chunks over
the chunk maxima (`chunkmax.select`, `ops/topk.blockmax_topk`), in the span window."""
import statistics

from portbench import spans


def read(ctx):
    ms = spans.device_ms(ctx, "chunkmax.select")
    return statistics.median(ms) if ms else None
