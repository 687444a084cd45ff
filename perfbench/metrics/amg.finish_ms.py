"""Host ms an image inside the generator's ``prefetch`` and ``finish`` (the
survivors' metadata, their upscale's run boundaries, the RLE and the
annotations), on the harness's clock around those calls."""


def read(ctx):
    return ctx.host["finish_ms"]
