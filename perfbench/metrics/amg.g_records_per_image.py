"""Recordings of kernel G's launch sequence an image (the program's counter
``twoway.g_records``); the chunks of one image replay one recording."""


def read(ctx):
    from pbcore.spans import counter
    n = counter("twoway.g_records")
    return None if n is None else n / ctx.steps
