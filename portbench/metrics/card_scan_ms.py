"""`card_scan_ms`: for each card, the median device ms of its local scan
(`sharded_scan.local`: scores, top-k, id gather) in the span window; the largest over
the cards."""
import statistics

from portbench import spans


def read(ctx):
    per_card = [spans.device_ms(ctx, "sharded_scan.local", c) for c in spans.cards(ctx)]
    per_card = [statistics.median(ms) for ms in per_card if ms]
    return max(per_card) if per_card else None
