"""`idle_share` (%): the share of the traced window in which no operation ran on a card,
the worst card."""


def read(ctx):
    t = ctx.traced
    if not t["busy_by_card"]:
        return None
    busiest_idle = max(1.0 - t["busy_by_card"].get(c, 0.0) / t["window_s"] for c in range(ctx.chips))
    return 100.0 * busiest_idle
