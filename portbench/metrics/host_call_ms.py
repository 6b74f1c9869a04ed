"""`host_call_ms`: the median host time for the program's call to return, without a
synchronisation, over the measured window's batches."""
import statistics


def read(ctx):
    calls = ctx.window["call_s"]
    return statistics.median(calls) * 1e3 if calls else None
