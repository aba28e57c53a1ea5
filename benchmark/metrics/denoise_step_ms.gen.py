"""One DDIM step of a request's denoising loop: the span around
``serve.sample_latent``, synchronised at its ends, over its steps, the
median over the window's requests, in ms."""

from benchmark import readings


def read(ctx):
    return readings.span_ms(ctx, "denoise", ctx.get("sample_steps", 1))
