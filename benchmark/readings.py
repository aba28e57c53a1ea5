"""What the per-layer metric readers share (``benchmark/metrics/``)."""

from __future__ import annotations

from . import harness, work

# the fused conv kernels B1–B3 by the names the profiler gives them: B1 and
# B2 are one kernel with its cast pass, B3 its passes in one namespace
FUSED_CONV_KERNELS = ("fused_sparse_conv_kernel", "cast_operands_kernel",
                      "fused_sparse_conv_dw::")


def for_tag(ctx: dict, tag: str) -> bool:
    return ctx.get("tag") == tag


def fused_roofline(ctx: dict, tag: str):
    """Σ the launches' bounds over the B1–B3 kernels' device time, in %."""
    if not for_tag(ctx, tag) or "trace" not in ctx:
        return None
    t = sum(b - a for name, a, b in ctx["trace"]["kernels"]
            if any(k in name for k in FUSED_CONV_KERNELS))
    bound = ctx.get("fused_bound_s")
    if t <= 0 or not bound:
        return None
    return 100.0 * bound / t


def idle_share(ctx: dict, tag: str):
    if not for_tag(ctx, tag) or "trace" not in ctx:
        return None
    lo, hi = ctx["trace"]["window"]
    return 100.0 * (1.0 - harness.busy_seconds(ctx["trace"]) / (hi - lo))


def mfu(ctx: dict, tag: str):
    """Model FLOPs of the window over its seconds at the bf16 peak, in %."""
    if not for_tag(ctx, tag) or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * work.PEAK_FLOPS)


def span_ms(ctx: dict, name: str, per: float = 1.0):
    """The median of a synchronised span's seconds, in ms, over ``per``."""
    spans = ctx.get("spans", {}).get(name)
    if not spans:
        return None
    return 1e3 * harness.median(spans) / per
