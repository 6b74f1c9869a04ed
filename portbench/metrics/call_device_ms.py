"""`call_device_ms`: the median, over the span window's calls, of the lead card's device
time of the program's call (`flat_scan.call`, `sharded_scan.call`): from the call's
first device work to its last, waits inside it included.

The harness's own device work between calls, making the next batch's queries and
copying the top-k out, lies outside the spans; it takes microseconds a batch."""
import statistics

from portbench import spans


def read(ctx):
    lead = spans.lead_card(ctx)
    if lead is None:
        return None
    ms = [m for name in spans.CALLS for m in spans.device_ms(ctx, name, lead)]
    return statistics.median(ms)
