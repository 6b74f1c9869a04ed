"""`k7_roofline` (%): K7's bound for this batch's inputs over its device time a launch
(`roofline.k7_work`, the profiler's K7 events)."""
from portbench.metrics._kernel import roofline


def read(ctx):
    return roofline(ctx, "K7")
