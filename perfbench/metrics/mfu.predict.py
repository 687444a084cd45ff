"""The predict step's model operations (``counts.predict_flops``: products
and attention from the configuration's shapes, no recomputation) over its
time on the host's clock, at the bf16 peak."""


def read(ctx):
    from pbcore.readers import mfu
    return mfu(ctx, ctx.counts.predict_flops(ctx.cfg, ctx.traffic))
