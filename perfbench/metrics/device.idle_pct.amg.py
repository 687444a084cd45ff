"""The share of the traced AMG window in which no kernel, copy or set
ran on the card."""


def read(ctx):
    from pbcore.readers import idle_pct
    return idle_pct(ctx)
