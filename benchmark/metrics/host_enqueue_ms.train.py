"""The host's seconds in each train step call of the window (no
synchronisation: the host enqueues), their median in ms."""

from benchmark import harness


def read(ctx):
    host = ctx.get("host_enqueue_s")
    return 1e3 * harness.median(host) if host else None
