"""`shard_scan_roofline` (%): each card's bytes bound for a batch (its rows read once,
the queries, its local list) over its busy device time a batch in the traced window,
the worst card."""


def read(ctx):
    t = ctx.traced
    if "card_bytes_ms" not in ctx.work or len(t["busy_by_card"]) < ctx.chips:
        return None
    busiest_ms = max(t["busy_by_card"].values()) * 1e3 / t["batches"]
    return 100.0 * ctx.work["card_bytes_ms"] / busiest_ms
