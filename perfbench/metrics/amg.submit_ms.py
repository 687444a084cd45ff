"""Host ms an image in the program's span ``amg.submit``: the encoder's
and the decoder's launches, the selection, and the waits inside them."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["amg.submit"], "host_ms")
