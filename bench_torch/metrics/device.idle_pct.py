"""device.idle_pct: the device's idle share of the traced cycle, 1 - busy
/ span, the span from the first operation's start to the last one's end."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["span_us"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["span_us"])
