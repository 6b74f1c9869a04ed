"""`batch_mfu` (%): a batch's least time on the chip (the larger of its operations, each
at its type's published peak, and its bytes at 3.35 TB/s, each input byte read once and
each output byte written once; `entries/<entry>.py` `work`) over its measured time (the
measured window over the batches completed in it)."""


def read(ctx):
    done = ctx.window["done"]
    if not done or "batch_ms" not in ctx.work:
        return None
    return 100.0 * ctx.work["batch_ms"] / (ctx.seconds * 1e3 / done)
