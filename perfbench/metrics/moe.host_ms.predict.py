"""Host ms a predict call in the program's spans ``llm.moe`` (one a MoE
layer: the router, the dispatch, the grouped products, the combine and the
shared experts, as the host launches them)."""


def read(ctx):
    from pbcore.spans import span_ms
    return span_ms(ctx, ["llm.moe"], "host_ms")
