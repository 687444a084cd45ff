"""The predict step's model operations with the MoE decoder
(``counts_mla_moe.predict_flops``: the towers, the MLA projections and
attention, the dense layer, the routers, the shared experts and each
token's top k routed experts, from the configuration's shapes) over its
time on the host's clock, at the bf16 peak."""


def read(ctx):
    from pbcore import counts_mla_moe as M
    from pbcore.readers import mfu
    return mfu(ctx, M.predict_flops(ctx.cfg, ctx.traffic))
