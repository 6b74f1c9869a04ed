"""`merge_ms`: the median device ms of the merge across the mesh on the lead card
(`merge.across_mesh`: the copies in, the wait for the slowest card, the stable top-k),
in the span window."""
import statistics

from portbench import spans


def read(ctx):
    lead = spans.lead_card(ctx)
    ms = spans.device_ms(ctx, "merge.across_mesh", lead) if lead is not None else []
    return statistics.median(ms) if ms else None
