"""Data-parallel training and evaluation on ``torch.distributed`` — port of
``mnc_tpu/parallel/mesh.py``.

The JAX package shards over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  Here a :class:`~torch.distributed.device_mesh.DeviceMesh`
names the axes, each process (rank) holds its share of the batch, and the
steps call the collectives themselves: a gradient all-reduce after the
backward, an all-reduce of the metrics, a gather of the detections.

Every collective is a ``broadcast`` or an ``all_reduce``: the two operations
that gloo also runs on CUDA tensors, so the same code runs on NCCL (one
process per GPU), on gloo with CPU tensors (the tests) and on gloo with
CUDA tensors (several ranks sharing one GPU).  A gather is an
``all_reduce`` of a zeroed buffer with one slot per rank: every element
adds one rank's value to zeros, which is exact.  The backend follows the
device (NCCL for ``cuda``, gloo for ``cpu``) unless it is named; nothing
falls back from one to the other.

    init_distributed()                  # torchrun's RANK / WORLD_SIZE / MASTER_*
    mesh = make_mesh(device="cuda")     # {"data": world}
    replicate(model, mesh)
    step = data_parallel_train_step(model, opt, arch, train_cfg, mesh)
    state, metrics = step(state, shard_batch(global_batch, mesh), generator)
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None, backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``coordinator`` (``host:port``, or an
    ``init_method`` URL such as ``file:///path``), ``num_processes`` and
    ``process_id`` as the JAX package takes them, else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  A no-op
    for one process, and where the group exists already.  ``backend``
    defaults to :func:`backend_for` ``device``."""
    if dist.is_initialized():
        return
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if coordinator is None:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or backend_for(device or "cuda"), init_method=url,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _single_rank_group(backend: str) -> None:
    """A one-rank group on a private file, so that ``--dp`` runs without
    a launcher."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="mnc_pg_")
    os.close(fd)
    os.unlink(path)  # the store creates it
    dist.init_process_group(backend, init_method=f"file://{path}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def make_mesh(axes: dict[str, int] | None = None, device=None,
              backend: str | None = None):
    """A ``DeviceMesh`` over every rank, ``{"data": world}`` by default;
    ``axes`` names the dims, row-major over the ranks (``{"data": 2,
    "model": 2}``: ranks 0, 1 share data index 0).  At world size 1 without
    a group it sets one up itself."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device or "cuda")
    if not dist.is_initialized():
        _single_rank_group(backend or backend_for(device))
    world = dist.get_world_size()
    axes = {"data": world} if axes is None else dict(axes)
    shape = tuple(int(v) for v in axes.values())
    n = 1
    for v in shape:
        n *= v
    if n != world:
        raise ValueError(f"mesh {axes} has {n} ranks; the group has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    return mesh[axis].size()


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def replicate(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` broadcast from rank 0 (of
    the whole mesh), in place; returns ``model``."""
    if mesh.size() == 1:
        return model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            buf = t.data.contiguous()  # channels-last convolution weights on the GPU
            dist.broadcast(buf, 0)
            if buf.data_ptr() != t.data.data_ptr():
                t.data.copy_(buf)
    return model


def shard_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """This rank's slice of the leading (image) axis of every array of the
    global ``batch`` (numpy or torch)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by mesh axis {axis}={n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return {k: take(v) for k, v in batch.items()}


def slice_draws(draws, start: int, size: int):
    """The images [start, start + size) of a ``StepDraws``/``CfmDraws``
    (tuples of tensors with a leading image axis; ``None`` stays)."""
    return type(draws)(*(None if f is None else tuple(t[start:start + size] for t in f)
                         for f in draws))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in a new tensor of ``t``'s dtype.
    The collective runs in float32 or float64, which gloo sums on CUDA
    tensors as well: types of 16 bits or fewer travel as float32, wider
    integers as float64, both exactly."""
    if t.dtype in (torch.float32, torch.float64):
        out = t.clone()
    elif t.is_floating_point() or t.element_size() <= 2:
        out = t.to(torch.float32)
    else:
        out = t.to(torch.float64)
    dist.all_reduce(out, group=group)
    return out if out.dtype == t.dtype else out.to(t.dtype)


def all_reduce_mean_(tensors: list, group, n: int) -> None:
    """Average ``tensors`` over ``group`` in place: flattened into buckets
    of one dtype each (at most ``BUCKET_BYTES``, a larger tensor alone), in
    list order, so that every run sums the same way."""
    for bucket in _buckets(tensors):
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in bucket]), group)
        if n > 1:
            flat.div_(n)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


BUCKET_BYTES = 256 << 20


def _buckets(tensors: list) -> list:
    out, cur, size = [], [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or size + nb > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        out.append(cur)
    return out


def reduce_gradients(model: torch.nn.Module, group, n: int, layout: dict) -> None:
    """The gradients averaged over ``group``.  A parameter without a
    gradient (a frozen block) stays without one on every rank; the set of
    parameters with gradients is checked against the first step's
    (``layout``), which every rank shares."""
    named = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
    have = tuple(name for name, p in named if p.grad is not None)
    if "names" not in layout:  # every rank's count equal iff (Σc)² = n·Σc²
        c = float(len(have))
        sums = all_reduce_sum(torch.tensor([c, c * c], device=named[0][1].device), group)
        if float(sums[0]) ** 2 != n * float(sums[1]):
            raise RuntimeError("data parallel: the ranks' parameters with gradients differ "
                               f"({len(have)} here)")
        layout["names"] = have
    elif have != layout["names"]:
        raise RuntimeError("data parallel: the parameters with gradients changed")
    all_reduce_mean_([p.grad for _, p in named if p.grad is not None], group, n)


def reduce_metrics(metrics: dict, group, n: int) -> dict:
    """Every metric (0-dim) averaged over ``group``, in one all-reduce (the
    ranks' ``mnc_loss`` names them in the same order)."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean_([flat], group, n)
    return dict(zip(keys, flat.unbind()))


def data_parallel_train_step(model, opt, arch, train_cfg: dict, mesh, axis: str = "data"):
    """The DP train step, with the signature of ``loop.build_train_step``'s
    product: ``step(state, batch, draws) -> (state, metrics)``.

    ``batch`` is this rank's share of the global batch (``shard_batch``);
    ``draws`` is a ``torch.Generator`` seeded alike on every rank, or the
    global batch's ``StepDraws``.  The draws are made for the GLOBAL batch
    and each rank takes its images' rows, so an image gets the draws it
    gets in the single-process step, as the JAX package splits its keys
    over the global batch.  Each rank runs ``mnc_loss`` on its images and
    the backward; the gradients and the metrics are then averaged over the
    axis (the global mean), and ``opt.step()`` updates the replicated
    parameters alike on every rank (``TRAIN.CLIP_GRADIENTS`` sees the
    global gradient)."""
    return sharded_train_step(model, opt, arch, train_cfg, mesh, axis)


def sharded_train_step(model, opt, arch, train_cfg: dict, mesh, axis: str,
                       local_draws=None, grad_sq_norm=None):
    """The step of :func:`data_parallel_train_step`; ``local_draws`` maps
    this rank's draws further (the TP step slices the keep-masks) and
    ``grad_sq_norm`` goes to ``opt.step``."""
    from mnc_tpu_torch.train.loop import deterministic_cudnn, draw_step_randoms, mnc_loss

    group, n, i = mesh.get_group(axis), axis_size(mesh, axis), axis_index(mesh, axis)
    anchors = model.anchors
    layout: dict = {}

    def step(state, batch: dict, draws):
        b = batch["image"].shape[0]
        if isinstance(draws, torch.Generator):
            draws = draw_step_randoms(draws, arch, train_cfg, b * n,
                                      batch["gt_boxes"].shape[-2], model.device)
        draws = slice_draws(draws, i * b, b)
        if local_draws is not None:
            draws = local_draws(draws)
        with deterministic_cudnn():
            total, metrics = mnc_loss(model, batch, draws, arch, anchors, train_cfg)
            total.backward()
            reduce_gradients(model, group, n, layout)
            metrics = reduce_metrics(metrics, group, n)
            opt.step(grad_sq_norm=grad_sq_norm)
        state.step += 1
        return state, metrics

    return step


def gather_rows(out: dict, mesh, axis: str = "data") -> dict:
    """Every rank's (b, ...) tensors stacked into (b · n, ...) on every
    rank, in rank order: an all-reduce of zeros with one slot per rank."""
    group, n, i = mesh.get_group(axis), axis_size(mesh, axis), axis_index(mesh, axis)
    res = {}
    for k in sorted(out):
        v = out[k]
        buf = v.new_zeros((n, *v.shape))
        buf[i] = v
        res[k] = all_reduce_sum(buf, group).reshape(n * v.shape[0], *v.shape[1:])
    return res


def data_parallel_eval_step(runner, mesh, axis: str = "data"):
    """Batched inference sharded over ``axis``: ``runner(image, im_info)``
    takes ONE image and returns a dict of fixed-shape tensors; the step
    ``fn(images, im_infos)`` takes the GLOBAL batch on every rank, runs this
    rank's images one at a time and returns every image's outputs, stacked
    in batch order, on every rank.

    One image at a time is what the JAX package's step computes (a ``vmap``
    of the one-image runner): under ``TEST.INT8`` each activation scale then
    covers one image, not the whole batch as ``MNC.apply_batch``'s does."""

    def fn(images, im_infos) -> dict:
        mine = shard_batch({"image": images, "im_info": im_infos}, mesh, axis)
        outs = [runner(im, info) for im, info in zip(mine["image"], mine["im_info"])]
        stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return gather_rows(stacked, mesh, axis)

    return fn
