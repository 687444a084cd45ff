"""The (dp, fsdp, tp) device mesh of the JAX package's ``parallel/mesh.py``,
one process a device.

Rank ``r`` sits at ``(d, f, t)`` with ``r = (d * fsdp + f) * tp + t``, the
order in which JAX reshapes its device list.  The batch's leading axis is
split over (dp, fsdp): ``fsdp`` is a second data axis in ZeRO style, so the
*data* group of a rank is every rank with its ``t``, and its data rank is
``d * fsdp + f``.  The tp ranks of one data rank see the same rows.

LLaMA's parameters are sharded by JAX's rules (:func:`param_spec`): the
head and MLP axes over ``tp`` (Megatron's column split for q, k, v, gate,
up and LoRA B; the row split for o and down, whose partial products are
summed over tp), the vocabulary of embed_tokens and lm_head over ``tp``,
and the other axis of each over ``fsdp``.  The towers, the projector, the
selection head and every 1-D parameter stay whole on every rank.  A
quantized projection (``models.layers``' int8, W8A8 and int4 modules)
holds its codes and scales as buffers, laid out as JAX's quantized leaves
come out on its mesh (:func:`quant_spec`): the int8 codes as the weight,
the scales and the bias along the output axis's mesh axis, int4's packed
codes and group scales along the output axis alone (a group of 128 inputs
is never cut).

The collectives are explicit, through the helpers below:

  * a frozen weight stored as its 1/fsdp block is all-gathered
    (:func:`fsdp_weight`; a quantized block's codes and scales,
    :func:`fsdp_module`) where a layer uses it and dropped after; a
    trainable one (LoRA A, embed_tokens, lm_head) is gathered by a
    ``Function`` whose backward reduce-scatters the gradient over fsdp, so
    the gradient and the optimizer state live on the block alone;
  * :func:`copy_to_tp` (Megatron's "f": the identity forward, an
    all-reduce of the gradient over tp) goes before a column-split
    product, :func:`reduce_from_tp` ("g": the all-reduce forward, the
    identity backward) after a row-split one, and :func:`gather_from_tp`
    gathers the vocabulary-split logits (its backward takes this rank's
    columns);
  * after backward, :func:`reduce_grads` sums the gradients over the data
    group (over dp alone for the fsdp-sharded ones, whose fsdp sum the
    reduce-scatter made) and :func:`grad_norm` is the norm of the whole
    gradient, each sharded block's squares summed over its axes and a
    replicated tensor counted once.

The gathers are list all-gathers into a ``cat``, and the reduce-scatter is
``reduce_scatter_tensor`` on the gathered axis moved to the front: nccl and
gloo carry both, on CPU and CUDA tensors alike (torch 2.11 and 2.13).
Outside a process group the mesh is one device and every helper is the
identity.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from llmseg_tpu_torch.config import require_ported
from llmseg_tpu_torch.parallel import ddp

AXES = ("dp", "fsdp", "tp")
# the axes of LLaMA's (out, in) weights in the port's layout (_jax_rule on
# JAX's (in, out), reversed): the column split (q, k, v, gate, up, lm_head),
# the row split (o, down); LoRA's A (rank, in) and B (out, rank)
COLUMN, ROW = ("tp", "fsdp"), ("fsdp", "tp")
LORA_A, LORA_B = (None, "fsdp"), ("tp", None)

Spec = Tuple[Optional[str], ...]


@dataclass(eq=False)
class Mesh:
    """This process's place on the (dp, fsdp, tp) mesh and its groups: the
    process group of each axis it runs a collective over ("data", "dp",
    "fsdp", "tp"), made only where the mesh shards (fsdp or tp above 1);
    a data-parallel mesh uses the world for "data" and "dp"."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    rank: int = 0
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def sharded(self) -> bool:
        return self.fsdp > 1 or self.tp > 1

    def size(self, axis: str) -> int:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "data": self.dp * self.fsdp}[axis]

    def coord(self, axis: str) -> int:
        d, rest = divmod(self.rank, self.fsdp * self.tp)
        f, t = divmod(rest, self.tp)
        return {"dp": d, "fsdp": f, "tp": t, "data": d * self.fsdp + f}[axis]

    @property
    def data_rank(self) -> int:
        return self.coord("data")

    @property
    def data_size(self) -> int:
        return self.size("data")

    @property
    def data(self):
        """The data group, for ``ddp.global_sum`` and the meters: None
        outside a process group (their identity)."""
        return self.groups.get("data")


def mesh_shape(data: int, fsdp: int, tensor: int, world: int) -> Tuple[int, int, int]:
    """(dp, fsdp, tp) of a ``MeshConfig`` in a world of ``world`` processes:
    ``data`` -1 takes what fsdp and tp leave, as JAX's ``make_mesh``.
    Raises ``ValueError`` unless the product is the world size (JAX asserts
    that the mesh fits its devices)."""
    fsdp, tensor = max(fsdp, 1), max(tensor, 1)
    dp = data if data > 0 else world // (fsdp * tensor)
    if dp < 1 or dp * fsdp * tensor != world:
        raise ValueError(f"mesh data={data}, fsdp={fsdp}, tp={tensor}: dp x fsdp x tp must be "
                         f"the world size {world} (one device a process)")
    return dp, fsdp, tensor


def _members(axis: str, dp: int, fsdp: int, tp: int):
    """Every group of ``axis``, as lists of ranks, in one fixed order."""
    rank = lambda d, f, t: (d * fsdp + f) * tp + t  # noqa: E731
    if axis == "data":
        return [[rank(d, f, t) for d in range(dp) for f in range(fsdp)] for t in range(tp)]
    if axis == "dp":
        return [[rank(d, f, t) for d in range(dp)] for f in range(fsdp) for t in range(tp)]
    if axis == "fsdp":
        return [[rank(d, f, t) for f in range(fsdp)] for d in range(dp) for t in range(tp)]
    return [[rank(d, f, t) for t in range(tp)] for d in range(dp) for f in range(fsdp)]


def make_mesh(cfg=None) -> Mesh:
    """The mesh of ``cfg`` (a ``MeshConfig``; the default is data-parallel
    over the world) on the process group ``ddp.init_from_env`` joined.
    Every process makes every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    data, fsdp, tensor = (-1, 1, 1) if cfg is None else (cfg.data, cfg.fsdp, cfg.tensor)
    dp, fsdp, tp = mesh_shape(data, fsdp, tensor, ddp.world_size())
    mesh = Mesh(dp, fsdp, tp, rank=ddp.rank())
    if not ddp.active():
        return mesh
    if not mesh.sharded:
        mesh.groups = {"data": dist.group.WORLD, "dp": dist.group.WORLD}
        return mesh
    for axis in ("data", "dp", "fsdp", "tp"):
        for ranks in _members(axis, dp, fsdp, tp):
            group = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axis] = group
    return mesh


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _jax_rule(joined: str, ndim: int) -> Spec:
    """``_llm_spec`` of the JAX package on a path inside llm / lora, in
    JAX's layout: dense kernels (in, out), embed_tokens (V, D), LoRA A
    (in, r), B (r, out)."""
    if ndim < 2:
        return (None,) * ndim
    if "embed_tokens" in joined:
        return ("tp", "fsdp")
    if "lm_head" in joined:
        return ("fsdp", "tp")
    if "attn/q" in joined or "attn/k" in joined or "attn/v" in joined:
        return ("fsdp", "tp")
    if "attn/o" in joined:
        return ("tp", "fsdp")
    if "mlp/gate" in joined or "mlp/up" in joined:
        return ("fsdp", "tp")
    if "mlp/down" in joined:
        return ("tp", "fsdp")
    if joined.endswith("/a"):
        return ("fsdp", None)
    if joined.endswith("/b"):
        return (None, "tp")
    return (None,) * ndim


def _jax_path(name: str) -> Tuple[str, bool]:
    """A port parameter name inside llm / lora as JAX's path, and whether
    the port stores that leaf transposed (an ``nn.Linear`` weight is
    (out, in); embed_tokens is not transposed)."""
    base = name[:-len(".weight")] if name.endswith(".weight") else name
    path = base.replace(".", "/")
    if base.endswith("embed_tokens"):
        return path, False
    if base.endswith((".a", ".b")):
        return path, True
    return path + "/w", name.endswith(".weight")


def param_spec(model: nn.Module) -> Dict[str, Spec]:
    """{parameter or quantized buffer name: the mesh axis of each of its
    dims, or None}: JAX's ``param_spec`` on the port's names and layouts.
    LLaMA's leaves (``llava.llm.*``) and LoRA's (``lora.*``) follow
    ``_llm_spec``, stated on JAX's axes and reversed where the port stores
    a leaf transposed; the buffers of LLaMA's quantized projections follow
    :func:`quant_spec`; everything else is replicated."""
    specs = {}
    for name, p in model.named_parameters():
        spec: Spec = (None,) * p.ndim
        for prefix in ("llava.llm.", "lora."):
            if name.startswith(prefix):
                path, transposed = _jax_path(name[len(prefix):])
                spec = _jax_rule(path, p.ndim)
                if transposed and p.ndim == 2:
                    spec = spec[::-1]
        specs[name] = spec
    specs.update({n: quant_spec(out, buf, t.ndim) for n, out, buf, t in _quant_buffers(model)})
    return specs


def out_axis(path: str) -> Optional[str]:
    """The mesh axis of the output dim of LLaMA's projection at ``path``
    (a module path inside the ``Llama``): "tp" for the column split (q, k,
    v, gate, up, lm_head), "fsdp" for the row split (o, down)."""
    return _jax_rule(path.replace(".", "/") + "/w", 2)[1]


def quant_spec(out: Optional[str], buf: str, ndim: int) -> Spec:
    """The axes of a quantized projection's buffer in the port's layouts,
    given the output axis's mesh axis ``out``: the int8 codes ``w_q`` /
    ``w_q8a`` (out, in) as the bf16 weight (the input axis over the other
    of fsdp and tp); ``w_scale`` and the bias (out,), int4's ``w_q4`` (out,
    padded_in / 2) and ``w_scale4`` (out, n_groups) along the output axis
    alone."""
    if buf in ("w_q", "w_q8a"):
        return {"tp": COLUMN, "fsdp": ROW}.get(out, (None, None))
    return (out,) + (None,) * (ndim - 1)


def local_block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole tensor (a view)."""
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis else 1
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not divide over "
                             f"{axis}={n}")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.coord(axis) * size, size)
    return t


def gather_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from this rank's block (collective over the
    tensor's axes; the block itself where it is not sharded)."""
    for dim, axis in enumerate(spec):
        if axis and mesh.size(axis) > 1:
            t = all_gather(t, dim, mesh.groups[axis], mesh.size(axis))
    return t


def _llm(model: nn.Module):
    """An ``LLMSeg``'s LLaMA, or None for another module."""
    llava = getattr(model, "llava", None)
    return getattr(llava, "llm", None)


def _llm_modules(model: nn.Module):
    llm = _llm(model)
    return llm, [llm, *llm.layers]


def _quant_buffers(model: nn.Module):
    """(name, the output axis's mesh axis, buffer name, tensor) of every
    buffer of an ``LLMSeg``'s quantized LLaMA projections."""
    from llmseg_tpu_torch.ops import quant

    llm = _llm(model)
    for path, m in ([] if llm is None else llm.named_modules()):
        if quant.is_quantized(m):
            for buf, t in m.named_buffers(recurse=False):
                yield f"llava.llm.{path}.{buf}", out_axis(path), buf, t


def _named_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter, and every buffer of LLaMA's quantized projections,
    by name."""
    return {**dict(model.named_parameters()),
            **{n: t for n, _, _, t in _quant_buffers(model)}}


def shard_buffers(m: nn.Module, out: Optional[str], mesh: Mesh) -> None:
    """Slice a quantized projection's buffers, in place, to this rank's
    blocks (:func:`quant_spec`)."""
    for buf, t in list(m.named_buffers(recurse=False)):
        block = local_block(t, quant_spec(out, buf, t.ndim), mesh)
        if block.shape != t.shape:
            m._buffers[buf] = block.clone()


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """Slice every parameter of an ``LLMSeg``, and every buffer of its
    LLaMA's quantized projections, in place to this rank's block
    (:func:`param_spec`) and hand the mesh to the model and its LLaMA.
    Returns the specs."""
    from llmseg_tpu_torch.ops import quant

    require_ported(model.llava.llm.cfg, "mesh")

    specs = param_spec(model)
    if mesh.sharded:
        llm, owners = _llm_modules(model)
        for name, p in model.named_parameters():
            block = local_block(p.data, specs[name], mesh)
            if block.shape != p.shape:
                p.data = block.clone()
        for path, m in llm.named_modules():
            if quant.is_quantized(m):
                shard_buffers(m, out_axis(path), mesh)
        for m in owners:
            m.mesh = mesh
    model.mesh = mesh
    return specs


def gather_full(model: nn.Module, names: Optional[Iterable[str]] = None
                ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: {name: the whole tensor} for
    ``names`` (every parameter and quantized buffer when None), gathered
    over fsdp and tp; an unsharded one is returned as it is.  Every rank
    must call it."""
    mesh = getattr(model, "mesh", None)
    tensors = _named_tensors(model)
    names = list(tensors) if names is None else list(names)
    if mesh is None or not mesh.sharded:
        return {n: tensors[n] for n in names}
    specs = param_spec(model)
    with torch.no_grad():
        return {n: gather_tensor(tensors[n].detach(), specs[n], mesh) for n in names}


def gather_opt_state(state: dict, names, specs: Dict[str, Spec], mesh: Mesh) -> dict:
    """``TrainableOptimizer.state_dict()`` with its per-parameter tensors
    (AdamW's moments, the accumulated mean) gathered to whole shapes."""
    return _map_opt_state(state, names, specs, lambda t, s: gather_tensor(t, s, mesh))


def slice_opt_state(state: dict, names, specs: Dict[str, Spec], mesh: Mesh) -> dict:
    """The inverse of :func:`gather_opt_state`: whole tensors to blocks."""
    return _map_opt_state(state, names, specs,
                          lambda t, s: local_block(t, s, mesh).clone())


def _map_opt_state(state: dict, names, specs, fn) -> dict:
    names = list(names)
    adamw = dict(state["adamw"])
    adamw["state"] = {i: {k: fn(v, specs[names[i]]) if k in ("exp_avg", "exp_avg_sq") else v
                          for k, v in st.items()}
                      for i, st in state["adamw"]["state"].items()}
    return {**state, "adamw": adamw,
            "acc": [fn(a, specs[n]) for a, n in zip(state["acc"], names)]}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of ``group`` (``n`` ranks) concatenated along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum of ``x`` over ``group``, this rank's 1/n block along ``dim``."""
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over ``group``, as a new tensor."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group``, as a new tensor."""
    return all_reduce(x, group, dist.ReduceOp.MAX)


class _GatherFSDP(torch.autograd.Function):
    """A trainable block gathered over fsdp; the backward reduce-scatters
    the gradient, the sum over the fsdp ranks' rows of this block."""

    @staticmethod
    def forward(ctx, w, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return all_gather(w, dim, mesh.groups["fsdp"], mesh.fsdp)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.mesh.groups["fsdp"], ctx.mesh.fsdp), None, None


class _CopyToTP(torch.autograd.Function):
    """Megatron's "f": the identity, and the gradient summed over tp."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh.groups["tp"]), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's "g": the sum of the tp ranks' partial products, and the
    gradient as it is."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.groups["tp"])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The tp ranks' blocks along ``dim``; the gradient of this rank's."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim, mesh, x.shape[dim]
        return all_gather(x, dim, mesh.groups["tp"], mesh.tp)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.coord("tp") * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def fsdp_weight(w: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """A weight stored as its fsdp block, whole along ``dim``: gathered
    without a graph when it is frozen (or no gradient is wanted), through
    :class:`_GatherFSDP` when it trains."""
    if mesh is None or mesh.fsdp == 1:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return _GatherFSDP.apply(w, dim, mesh)
    with torch.no_grad():
        return all_gather(w, dim, mesh.groups["fsdp"], mesh.fsdp)


def fsdp_module(m: nn.Module, out: Optional[str], mesh: Optional[Mesh]) -> nn.Module:
    """A quantized projection whose codes and scales are stored as fsdp
    blocks, with them whole over fsdp (:func:`quant_spec` with output axis
    ``out``): a shallow copy that holds the gathered buffers, dropped by
    the caller after its product.  The buffers are frozen: no graph."""
    if mesh is None or mesh.fsdp == 1:
        return m
    bufs = {}
    with torch.no_grad():
        for buf, t in m.named_buffers(recurse=False):
            spec = quant_spec(out, buf, t.ndim)
            bufs[buf] = (all_gather(t, spec.index("fsdp"), mesh.groups["fsdp"], mesh.fsdp)
                         if "fsdp" in spec else t)
    g = copy.copy(m)
    g._buffers = {**m._buffers, **bufs}
    return g


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.tp == 1:
        return x
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.tp == 1:
        return x
    return _ReduceFromTP.apply(x, mesh)


def gather_from_tp(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.tp == 1:
        return x
    return _GatherFromTP.apply(x, dim % x.dim(), mesh)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _sharded_over(spec: Spec, axis: str, mesh: Mesh) -> bool:
    return axis in spec and mesh.size(axis) > 1


def data_group(model: nn.Module):
    """The data group of a model's mesh: None (the world, or the identity
    outside a process group) for a model without one."""
    mesh = getattr(model, "mesh", None)
    return None if mesh is None else mesh.data


@torch.no_grad()
def reduce_grads(params: Dict[str, nn.Parameter], specs: Dict[str, Spec],
                 mesh: Optional[Mesh]) -> None:
    """Sum the micro-step's gradients over the data axes, in place: a
    tensor sharded over fsdp over dp (its reduce-scatter summed fsdp), any
    other over the data group.  Without a mesh, ``ddp.all_reduce_grads``
    over the world."""
    if mesh is None or not mesh.sharded:
        ddp.all_reduce_grads(params.values(), group=None if mesh is None else mesh.data)
        return
    by_fsdp = [p for n, p in params.items() if _sharded_over(specs[n], "fsdp", mesh)]
    rest = [p for n, p in params.items() if not _sharded_over(specs[n], "fsdp", mesh)]
    if mesh.data_size > 1:
        ddp.all_reduce_grads(rest, group=mesh.groups["data"])
    if mesh.dp > 1:
        ddp.all_reduce_grads(by_fsdp, group=mesh.groups["dp"])


@torch.no_grad()
def grad_norm(grads: Dict[str, torch.Tensor], specs: Dict[str, Spec],
              mesh: Mesh) -> torch.Tensor:
    """The global norm of the whole gradient from this rank's blocks: the
    squares of each block, accumulated in float32, summed over the axes it
    is sharded on; a replicated tensor counted once."""
    squares = {}
    for name, g in grads.items():
        key = tuple(a for a in ("fsdp", "tp") if _sharded_over(specs[name], a, mesh))
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        squares[key] = squares[key] + sq if key in squares else sq
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    rep, f, t, ft = (squares.get(k, zero) for k in ((), ("fsdp",), ("tp",), ("fsdp", "tp")))
    if mesh.tp > 1:
        t, ft = all_reduce(torch.stack([t, ft]), mesh.groups["tp"]).unbind()
    if mesh.fsdp > 1:
        f, ft = all_reduce(torch.stack([f, ft]), mesh.groups["fsdp"]).unbind()
    return (rep + f + t + ft).sqrt()
