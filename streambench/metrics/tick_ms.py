"""Mean host time of the control plane's tick (``ControlPlane.tick_times``)
over the window, in ms."""


def read(ctx):
    ts = ctx.rec.tick_s
    return 1e3 * sum(ts) / len(ts) if ts else None
