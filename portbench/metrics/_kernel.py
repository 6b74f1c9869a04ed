"""A port kernel's share of its roofline: the bound of one call over its mean device
time a launch in the traced window, in %."""
from __future__ import annotations


def roofline(ctx, kid: str):
    ms, launches = ctx.kernel_ms(kid)
    if not launches or kid not in ctx.work:
        return None
    return 100.0 * ctx.work[kid].least_ms() / ms
