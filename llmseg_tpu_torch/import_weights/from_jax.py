"""Load the JAX package's parameter tree into the port's modules.

The tree is given as nested dicts / lists of numpy arrays (for example
``jax.tree.map(np.asarray, params)``) or of torch tensors, which keep their
dtype (``import_weights.torch_import`` builds such trees from torch
checkpoints, bf16 included); nothing here imports JAX.  The port's module
names mirror the tree's keys, so each leaf maps by its path:

  * dense ``w`` (in, out)            -> ``<path>.weight`` (out, in)
  * conv kernel ``w`` HWIO           -> ``<path>.weight`` OIHW (patch
    embeds, SAM's convs, and the mask decoder's (2, 2, in, out)
    transposed-conv kernels, which ``ops.twoway_kernel.convt_as_matmul``
    flips spatially as ``jax.lax.conv_transpose`` applies them)
  * ``b`` (1-D)                      -> ``<path>.bias``
  * norm ``scale`` / ``bias``        -> ``<path>.weight`` / ``<path>.bias``
  * ``embed_tokens`` (V, C)          -> ``embed_tokens.weight``
  * ``pos_embed``, ``cls_token``, ``ls1``, ``ls2``, MPT's ``wte`` and
    ``wpe`` and SAM's
    ``rel_pos_h/w``, ``iou_token``, ``mask_tokens``, ``point_embeddings``,
    ``not_a_point_embed``, ``no_mask_embed``, ``gaussian`` -> same name
  * LoRA ``a`` (in, r), ``b`` (r, out) -> ``<path>.a.weight``, ``<path>.b.weight``
  * a quantized dense leaf (``ops.quant``): ``w_q`` / ``w_q8a`` (in, out)
    int8, ``w_q4`` (padded_in / 2, out) packed nibbles and ``w_scale4``
    (n_groups, out) -> the same names transposed to (out, ...), ``w_scale``
    as it is; the ``nn.Linear`` at that path becomes the matching
    quantized module (``layers.Int8Linear``, ``W8A8Linear``,
    ``Int4Linear``).  Both packings pair inputs 2i (low nibble) and 2i + 1,
    so the transposed bytes unpack to the same values.

Whole trees load as they are: ``llmseg.init``'s into ``LLMSeg``, a
``llava.init`` tree with a ``"lora"`` key into ``train.sft.LlavaSFT``, one
whose ``"llm"`` is an ``mpt.init`` tree into ``Llava(..., mpt_cfg=...)``.
LayerScale leaves missing from a block the tree names (a folded DINOv2) are
removed from the module too.  Every leaf must land; by default the load is
strict, so every parameter of the module must come from the tree, and
``strict=False`` leaves the parameters the tree does not name as they are
(a checkpoint set arrives in parts).  A subtree loads into the submodule
it describes (``load_(model.dino, dino_tree)``).  The layout maps are
linear, so a gradient tree flattens the same way as a parameter tree.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch
from torch import nn

from llmseg_tpu_torch.models import layers as L

# a quantized leaf's weight name -> (its module, its scale's name)
_QUANT_LEAVES = {"w_q": (L.Int8Linear, "w_scale"), "w_q8a": (L.W8A8Linear, "w_scale"),
                 "w_q4": (L.Int4Linear, "w_scale4")}


Array = Union[np.ndarray, torch.Tensor]


def _permute(arr: Array, *axes) -> Array:
    return arr.permute(*axes) if torch.is_tensor(arr) else arr.transpose(*axes)


def _tensor(arr: Array) -> torch.Tensor:
    """A torch tensor of the leaf's dtype; a bf16 numpy array (ml_dtypes,
    what a bf16 JAX array or safetensors' numpy reader gives) by its bits."""
    if torch.is_tensor(arr):
        return arr
    if arr.dtype.name == "bfloat16":
        return torch.tensor(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(arr)


def flatten(tree, prefix: str = "") -> Dict[str, Array]:
    """{port parameter name: array in the port's layout}; torch leaves stay
    tensors of their own dtype, other leaves become numpy arrays."""
    out: Dict[str, Array] = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    for key, val in items:
        path = f"{prefix}{key}"
        if isinstance(val, (dict, list, tuple)):
            out.update(flatten(val, path + "."))
            continue
        arr = val if torch.is_tensor(val) else np.asarray(val)
        if key == "w":
            name = f"{prefix}weight"
            arr = _permute(arr, 3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif key == "b" and arr.ndim == 2:      # LoRA B
            name, arr = f"{path}.weight", arr.T
        elif key == "a":                         # LoRA A
            name, arr = f"{path}.weight", arr.T
        elif key in ("w_q", "w_q8a", "w_q4", "w_scale4"):
            name, arr = path, arr.T
        elif key in ("b", "bias"):
            name = f"{prefix}bias"
        elif key == "scale":
            name = f"{prefix}weight"
        elif key == "embed_tokens":
            name = f"{path}.weight"
        else:
            name = path
        out[name] = arr.contiguous() if torch.is_tensor(arr) else np.ascontiguousarray(arr)
    return out


def flatten_paths(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A flat ``{"a/b/0/w": array}`` dict, as the JAX package's
    ``optim.partition`` returns its trainable subset (and a gradient or an
    optimizer step over it), in the port's names and layouts."""
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val
    return flatten(tree)


def _place_quantized(module: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Swap in a quantized module for each quantized leaf of the tree,
    taking its arrays out of ``flat``; the bias is cast to the replaced
    ``nn.Linear``'s dtype, everything goes to its device."""
    for name in [n for n in flat if n.rpartition(".")[2] in _QUANT_LEAVES]:
        prefix, _, leaf = name.rpartition(".")
        lin = module.get_submodule(prefix)
        if not isinstance(lin, nn.Linear):
            raise KeyError(f"{name}: the module at {prefix!r} is not an nn.Linear")
        cls, scale = _QUANT_LEAVES[leaf]
        bias = flat.pop(f"{prefix}.bias", None)
        q = cls(_tensor(flat.pop(name)), _tensor(flat.pop(f"{prefix}.{scale}")),
                None if bias is None else _tensor(bias).to(lin.weight.dtype))
        parent, _, attr = prefix.rpartition(".")
        setattr(module.get_submodule(parent), attr, q.to(lin.weight.device))


def quant_stats(stats, device="cpu") -> List[Dict[str, torch.Tensor]]:
    """``llmseg.calibrate_quant_stats``'s per-layer column maxima (dicts of
    arrays) as float32 tensors on ``device``."""
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
             for k, v in st.items()} for st in stats]


@torch.no_grad()
def load_(module: nn.Module, tree, *, strict: bool = True) -> nn.Module:
    """Copy the tree into ``module`` (cast to its dtype and device).  A
    quantized leaf replaces the ``nn.Linear`` at its path.  ``strict``:
    every parameter of the module must come from the tree; without it the
    parameters the tree does not name keep their values."""
    flat = flatten(tree)
    _place_quantized(module, flat)
    for name, _ in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        if (leaf in ("ls1", "ls2") and name not in flat
                and any(k.startswith(owner_name + ".") for k in flat)):
            setattr(module.get_submodule(owner_name), leaf, None)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat)) if strict else []
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(f"tree/module mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    for name, val in flat.items():
        p, src = params[name], _tensor(val)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree {tuple(src.shape)} vs module {tuple(p.shape)}")
        p.copy_(src)
    return module
