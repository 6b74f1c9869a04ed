"""`span_idle_share` (%): for each card, the share of the span window, from its first
span's start to its last span's end, that none of its spans covers; the worst card.

The harness's own device work between calls, making the next batch's queries and
copying the top-k out, lies outside the spans and counts as idle here; it takes
microseconds a batch."""
from portbench import spans


def read(ctx):
    shares = [spans.idle_share(ctx, card) for card in spans.cards(ctx)]
    return 100.0 * max(shares) if shares else None
