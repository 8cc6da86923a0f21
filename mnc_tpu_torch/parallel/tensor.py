"""Tensor-parallel (and hybrid DP×TP) fc heads — port of
``mnc_tpu/parallel/tensor.py``.

The per-RoI fc stack holds most of MNC's parameters (fc6 alone is 25088 ×
4096 at full width).  On a ``{"data", "model"}`` mesh the images shard over
``data`` and the big fc layers Megatron-style over ``model``:
column-parallel ``fc6`` and ``fc_mask`` (each rank holds a slice of the
output features, with their bias; the ReLU and the dropout after them stay
sharded) and row-parallel ``fc7`` and ``mask_pred`` (each rank holds the
matching slice of the input features; the partial products are summed over
the axis before the replicated bias is added).  Everything else is
replicated.  ``nn.Linear.weight`` is (out, in), so column-parallel shards
dim 0 and row-parallel dim 1; the JAX rule names the (in, out) kernel's
other dim.

The JAX package lets GSPMD insert the collectives.  Here the two layer
kinds call them: a column-parallel layer all-reduces the gradient of its
(replicated) input in the backward, a row-parallel layer all-reduces its
output in the forward; both sums run in float32.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mnc_tpu_torch.parallel.mesh import (all_reduce_sum, axis_index, axis_size,
                                         sharded_train_step)

# column-parallel: output features shard; row-parallel: input features shard
_COL_PARALLEL = ("fc6", "fc_mask")
_ROW_PARALLEL = ("fc7", "mask_pred")


def _leaf_spec(name: str, ndim: int) -> int | None:
    """The dim of a parameter (``nn.Linear`` layout) that shards, or None."""
    parts = name.split(".")
    if any(n in parts for n in _COL_PARALLEL):
        return 0  # weight (out, in) and bias (out,): the outputs
    if any(n in parts for n in _ROW_PARALLEL) and ndim == 2:
        return 1  # weight (out, in): the inputs; the bias adds after the sum
    return None


def mnc_tp_shardings(model: nn.Module, mesh=None, model_axis: str = "model") -> dict:
    """For each parameter name of ``model``: ``(dim, model_axis)`` where it
    shards, ``None`` where it is replicated."""
    del mesh
    out = {}
    for name, p in model.named_parameters():
        dim = _leaf_spec(name, p.dim())
        out[name] = None if dim is None else (dim, model_axis)
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model axis (each rank computes it from its shard of the outputs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.float(), ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Sums the partial outputs over the model axis (in float32); the
    backward hands each rank the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return all_reduce_sum(x.float(), group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class ParallelLinear(nn.Module):
    """One rank's shard of an ``nn.Linear``: ``col`` (outputs sharded, the
    bias with them) or row (inputs sharded, the whole bias).  Called by
    ``models.heads.linear_cast`` through :meth:`forward_cast`."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, col: bool, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.col = col
        self.group = group

    def forward_cast(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        w, b = self.weight.to(dtype), self.bias.to(dtype)
        if self.col:
            return F.linear(_CopyToModel.apply(x, self.group), w, b)
        return _ReduceFromModel.apply(F.linear(x, w), self.group).to(dtype) + b

    def forward(self, x):
        return self.forward_cast(x, self.weight.dtype)


def _slice(t: torch.Tensor, dim: int, m: int, j: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % m:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {m} ranks")
    return t.narrow(dim, j * (size // m), size // m).clone()


def shard_train_state(state, mesh, model_axis: str = "model"):
    """Slice ``state``'s sharded parameters, and the solver's momentum
    traces and accumulators, to this rank's shard of ``model_axis``, in
    place: the fc layers become :class:`ParallelLinear` modules holding
    their shard, the solver's lists point at them.  Returns ``state``."""
    from mnc_tpu_torch.ops.quant import DenseInt8

    model, opt = state.model, state.opt
    group, m, j = mesh.get_group(model_axis), axis_size(mesh, model_axis), \
        axis_index(mesh, model_axis)
    index = {name: k for k, name in enumerate(opt.names)}
    for mod_name, mod in list(model.named_modules()):
        leaf = mod_name.rsplit(".", 1)[-1]
        if leaf not in _COL_PARALLEL + _ROW_PARALLEL:
            continue
        if isinstance(mod, DenseInt8) or not isinstance(mod, nn.Linear):
            raise ValueError(f"{mod_name}: only float nn.Linear layers shard (tensor "
                             "parallelism is for training)")
        col = leaf in _COL_PARALLEL
        new = {}
        for kind, p in (("weight", mod.weight), ("bias", mod.bias)):
            dim = _leaf_spec(f"{mod_name}.{kind}", p.dim())
            new[kind] = p.detach() if dim is None else _slice(p.detach(), dim, m, j)
            k = index[f"{mod_name}.{kind}"]
            if dim is not None:
                opt.trace[k] = _slice(opt.trace[k], dim, m, j)
                if opt.acc is not None:
                    opt.acc[k] = _slice(opt.acc[k], dim, m, j)
        shard = ParallelLinear(new["weight"].clone(), new["bias"].clone(), col, group)
        shard.weight.requires_grad_(mod.weight.requires_grad)
        shard.bias.requires_grad_(mod.bias.requires_grad)
        parent = model.get_submodule(mod_name.rsplit(".", 1)[0]) if "." in mod_name else model
        setattr(parent, leaf, shard)
        opt.params[index[f"{mod_name}.weight"]] = shard.weight
        opt.params[index[f"{mod_name}.bias"]] = shard.bias
    return state


def _sharded(opt) -> list:
    """Per solver entry: does it hold a shard?"""
    return [_leaf_spec(n, p.dim()) is not None for n, p in zip(opt.names, opt.params)]


def gather_full(t: torch.Tensor, name: str, mesh, model_axis: str = "model") -> torch.Tensor:
    """The whole tensor of a sharded parameter (or of its solver state)
    from every rank's shard: an all-reduce of zeros, one slot per rank."""
    dim = _leaf_spec(name, t.dim())
    if dim is None:
        return t
    m, j = axis_size(mesh, model_axis), axis_index(mesh, model_axis)
    shape = list(t.shape)
    shape[dim] *= m
    full = t.new_zeros(shape)
    full.narrow(dim, j * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce_sum(full, mesh.get_group(model_axis))


def save_checkpoint(directory: str, state, mesh, step: int | None = None,
                    model_axis: str = "model") -> str | None:
    """``utils.checkpoint.save_checkpoint`` of a TP-sharded state: every
    rank gathers the whole tensors (a collective: call it on every rank);
    global rank 0 writes the same ``train_state.npz`` a single process
    would.  Returns the path on rank 0, None elsewhere."""
    from mnc_tpu_torch.utils import checkpoint as C

    sd = {k: gather_full(v, k, mesh, model_axis) for k, v in state.model.state_dict().items()}
    o = state.opt.state_dict()
    o = dict(o, trace={k: gather_full(v, k, mesh, model_axis) for k, v in o["trace"].items()},
             acc=None if o["acc"] is None else
             {k: gather_full(v, k, mesh, model_axis) for k, v in o["acc"].items()})
    if dist.get_rank() != 0:
        return None
    # what save_train_state reads of a TrainState, with whole tensors
    whole = SimpleNamespace(step=state.step, model=SimpleNamespace(state_dict=lambda: sd),
                            opt=SimpleNamespace(state_dict=lambda: o))
    return C.save_checkpoint(directory, whole, step)


def hybrid_parallel_train_step(model, opt, arch, train_cfg: dict, mesh,
                               data_axis: str = "data", model_axis: str = "model"):
    """The DP × TP train step on a ``{data_axis, model_axis}`` mesh, on a
    state that :func:`shard_train_state` has sharded:
    ``step(state, batch, draws) -> (state, metrics)``.

    ``batch`` is this rank's share over ``data_axis`` (``shard_batch``);
    the ranks of one model group hold the same images.  ``draws`` (a
    generator seeded alike everywhere, or the global ``StepDraws``) are
    made for the global batch and sliced to this rank's images; the
    keep-masks after ``fc6`` are sliced along their last dim to its shard,
    those after ``fc7`` stay whole.  After the backward the gradients are
    averaged over ``data_axis``; the global gradient norm for
    ``TRAIN.CLIP_GRADIENTS`` sums the sharded leaves over ``model_axis``
    and counts the replicated ones once."""
    mgroup, m, j = mesh.get_group(model_axis), axis_size(mesh, model_axis), \
        axis_index(mesh, model_axis)
    if not any(isinstance(mod, ParallelLinear) for mod in model.modules()):
        raise ValueError("hybrid_parallel_train_step: shard the state first "
                         "(shard_train_state)")
    sharded = _sharded(opt)

    def sq_norm(grads):
        sq = [(g.float() ** 2).sum() for g in grads]
        part = all_reduce_sum(torch.stack([s for s, sh in zip(sq, sharded) if sh]).sum(), mgroup)
        rep = [s for s, sh in zip(sq, sharded) if not sh]
        return part + (torch.stack(rep).sum() if rep else 0.0)

    def local_keep(pair):
        k6, k7 = pair
        w = k6.shape[-1] // m
        return (k6[..., j * w:(j + 1) * w], k7)

    def local_draws(draws):
        return draws._replace(drop1=local_keep(draws.drop1), drop2=local_keep(draws.drop2))

    return sharded_train_step(model, opt, arch, train_cfg, mesh, data_axis, local_draws, sq_norm)
