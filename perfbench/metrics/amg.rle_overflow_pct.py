"""The share (%) of the survivors whose columns overflow the device RLE and
take the bit-packed path: the program's counters ``amg.rle_overflow`` over
``amg.survivors``."""


def read(ctx):
    from pbcore.spans import counter
    survivors = counter("amg.survivors")
    return 100.0 * counter("amg.rle_overflow") / survivors if survivors else None
