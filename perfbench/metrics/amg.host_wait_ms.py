"""Host ms an image blocked on the card in the program's waiting spans:
``amg.upload`` (the image, the grid and the filters' fill copied from
pageable memory, each after the stream drains), ``nms`` (its fixpoint's
test reads the card), ``amg.pull`` (the survivors' metadata) and
``amg.download`` (the RLE payload).  A lower bound: the encoder's own
waits (each block's relative-position index and q's scale copied to the
card, 96 an image, and ``preprocess``'s two) fall in ``amg.encode``, the
upscale's weights (two) in ``amg.upscale``, with launches between them
that no span can separate."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["amg.upload", "nms", "amg.pull", "amg.download"], "host_ms")
