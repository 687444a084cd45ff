"""SAM mask decoder, the counterpart of ``llmseg_tpu.models.sam.mask_decoder``:
IoU token and mask tokens before the prompt tokens, the two-way
transformer, the transposed-conv upscale (x4), hypernetwork MLPs and the
IoU head.

``predict_masks`` routes as the JAX function does: AMG-scale prompt
batches on the card (``twoway_kernel.should_fuse``), or any batch with
``impl="fused"``, take ``twoway_kernel.fused_decode_apply`` for inference:
a shared image embedding and dense prompt go to kernel G, a base per
prompt (an image embedding per prompt, or a dense mask prompt) to kernel
H.  Under autograd (grad enabled and a parameter requiring grad) they take
the plain tail, which is what the JAX ``custom_vjp`` computes value and
gradient with; ``impl="xla"`` takes it too.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from llmseg_tpu_torch.config import SamDecoderConfig
from llmseg_tpu_torch.models import layers as L
from llmseg_tpu_torch.models.sam.two_way_transformer import TwoWayTransformer
from llmseg_tpu_torch.ops import twoway_kernel


class ConvTranspose2x2(nn.Module):
    """A 2x2, stride-2 transposed conv, NHWC.  ``weight`` (out, in, 2, 2) is
    the bridge's transpose of the JAX (2, 2, in, out) kernel, which
    ``jax.lax.conv_transpose`` applies spatially flipped; the forward is
    its matmul form (``twoway_kernel.convt_as_matmul``), since output pixels
    never mix inputs."""

    def __init__(self, in_ch: int, out_ch: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 2, 2, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        w, _ = twoway_kernel.convt_as_matmul(self)
        co = self.weight.shape[0]
        y = torch.matmul(x.to(w.dtype).float(), w.float()).to(w.dtype)
        y = y.reshape(B, H, W, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, 2 * H, 2 * W, co) + self.bias


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.transformer_dim
        nt = cfg.num_multimask_outputs + 1
        self.cfg = cfg
        self.iou_token = nn.Parameter(torch.empty(1, d, **kw))
        self.mask_tokens = nn.Parameter(torch.empty(nt, d, **kw))
        self.transformer = TwoWayTransformer(cfg.transformer_depth, d,
                                             cfg.transformer_num_heads,
                                             cfg.transformer_mlp_dim, **kw)
        self.upscale_conv1 = ConvTranspose2x2(d, d // 4, **kw)
        self.upscale_ln = L.LayerNorm2d(d // 4, **kw)
        self.upscale_conv2 = ConvTranspose2x2(d // 4, d // 8, **kw)
        self.hyper_mlps = nn.ModuleList(L.MLPStack([d, d, d, d // 8], **kw) for _ in range(nt))
        self.iou_head = L.MLPStack([d] + [cfg.iou_head_hidden_dim] * (cfg.iou_head_depth - 1)
                                   + [nt], **kw)

    def plain_tail(self, src, image_pe, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_xla_tail``: transformer, upscale, hypernetwork and IoU head from
        the summed src onward.  Returns (masks float32, iou float32)."""
        B = tokens.shape[0]
        S, d = src.shape[1], self.cfg.transformer_dim
        nt = self.cfg.num_multimask_outputs + 1
        if src.shape[0] == 1 and B > 1:
            src = src.expand(B, *src.shape[1:])
        hs, keys = self.transformer(src, image_pe, tokens, impl="xla")
        up = self.upscale_conv1(keys.reshape(B, S, S, d))
        up = L.gelu_tanh(self.upscale_ln(up))
        up = L.gelu_tanh(self.upscale_conv2(up))
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in enumerate(self.hyper_mlps)], 1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), up.float())
        return masks, self.iou_head(hs[:, 0]).float()

    def predict_masks(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                      dense_shared: bool = False, impl: str = "auto", cache=None):
        """image_embeddings (B or 1, S, S, C); sparse (B, N, C); dense (B, S,
        S, C).  Returns (masks (B, nt, 4S, 4S), iou (B, nt)): from kernels G
        and H in the image dtype, from the plain tail in float32.  ``cache``:
        keeps the shared base and kernel G's recorded sequence while their
        inputs are unchanged (``twoway_kernel.cached``)."""
        B = sparse_prompt.shape[0]
        d = self.cfg.transformer_dim
        nt = self.cfg.num_multimask_outputs + 1
        out_tok = torch.cat([self.iou_token, self.mask_tokens], 0)
        tokens = torch.cat([out_tok[None].expand(B, nt + 1, d),
                            sparse_prompt.to(out_tok.dtype)], 1)
        S = image_embeddings.shape[1]
        fuse = impl == "fused" or (impl == "auto" and twoway_kernel.should_fuse(
            B, S * S, image_pe, image_embeddings.device))
        shared = image_embeddings.shape[0] == 1 and dense_shared and B > 1
        grad = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        nh = self.cfg.transformer_num_heads
        if fuse and shared and not grad:
            src = twoway_kernel.cached(cache, "base", [image_embeddings, dense_prompt[:1]],
                                       torch.add)
            return twoway_kernel.fused_decode_apply(self.transformer, self, src, image_pe,
                                                    tokens, nh, cache=cache)
        src = image_embeddings
        if src.shape[0] == 1 and B > 1:
            src = src.expand(B, *src.shape[1:])
        src = src + dense_prompt
        if fuse and not grad:
            return twoway_kernel.fused_decode_apply(self.transformer, self, src, image_pe,
                                                    tokens, nh)
        return self.plain_tail(src, image_pe, tokens)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool = True, dense_shared: bool = False,
                impl: str = "auto", cache=None):
        """Multimask outputs 1..3, or the single output 0."""
        masks, iou = self.predict_masks(image_embeddings, image_pe, sparse_prompt,
                                        dense_prompt, dense_shared=dense_shared, impl=impl,
                                        cache=cache)
        if multimask_output:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, 0:1], iou[:, 0:1]
