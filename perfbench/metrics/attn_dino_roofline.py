"""DINOv2's non-causal attention over its patch and class tokens (kernel B,
one launch a block): the bound from the shapes over kernel B's device
time (its keys' norm pass included)."""


def read(ctx):
    from pbcore.readers import roofline
    c, d, t = ctx.counts, ctx.cfg["dino"], ctx.traffic
    T = (d["image_size"] // d["patch_size"]) ** 2 + 1
    bh, hd = t["images_per_batch"] * d["num_attention_heads"], d["hidden_size"] // d["num_attention_heads"]
    per_launch, _ = c.bound(c.BF16 * 4 * bh * T * hd, c.attention_flops(T * T, bh, hd))
    return roofline(ctx, [("flash_fwd_1pass", per_launch, d["num_hidden_layers"])])
