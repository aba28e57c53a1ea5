"""A request's encode (``GenerationProgram.latent``) and pruning decode
(``VAE.decode``), each a span synchronised at its ends, their sum, the
median over the window's requests, in ms."""

from benchmark import readings


def read(ctx):
    spans = ctx.get("spans", {})
    if not spans.get("encode") or not spans.get("decode"):
        return None
    return 1e3 * readings.harness.median(
        [a + b for a, b in zip(spans["encode"], spans["decode"])])
