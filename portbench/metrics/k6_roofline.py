"""`k6_roofline` (%): K6's bound for this batch's inputs over its device time a launch
(`roofline.k6_work`, the profiler's K6 events)."""
from portbench.metrics._kernel import roofline


def read(ctx):
    return roofline(ctx, "K6")
