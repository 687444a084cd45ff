"""An AMG image's model operations (``counts.amg_image_flops``: the encoder
at its square input and every decode call) over the time an image takes
on the host's clock, at the bf16 peak."""


def read(ctx):
    from pbcore.readers import mfu
    return mfu(ctx, ctx.counts.amg_image_flops(ctx.cfg, ctx.traffic["amg"]))
