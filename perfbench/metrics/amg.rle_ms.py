"""Host ms an image in the program's span ``amg.rle`` less its children
(the bit-packed fallback): the annotations from the device's run
boundaries."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["amg.rle"], "self_ms")
