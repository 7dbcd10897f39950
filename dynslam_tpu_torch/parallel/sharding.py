"""("data", "model") sharding of DispNet-lite's training step on
``torch.distributed``: the counterpart of ``dynslam_tpu/parallel/
sharding.py``, where XLA derives the collectives from the shardings.
Here they are written out, so the sharded step computes what the
single-device step computes:

- "data" splits the batch. The masked L1 is a mean over the GLOBAL batch
  (``dispnet.py:75``): the mask count is all-reduced over "data" first,
  each rank backpropagates its share ``err_sum / count``, and the
  gradients are summed over "data". Averaging per-rank means would be
  another loss wherever the ranks' valid masks differ.
- "model" splits the output channels of every conv with >= 64 of them
  (``_param_spec``: 4-D kernels and 1-D biases of >= 64 entries; the rest
  is replicated). Such a conv computes its channel slice and all-gathers
  the slices (``_GatherChannels``); everything after it is replicated in
  the model group, so the loss is too, and the gather's backward takes
  the rank's own slice of the (replicated) output gradient. Its input's
  gradient from the local slice is partial, so ``_SumGradOverModel``
  (identity forward) all-reduces it over "model" on the way back.
  ``torch.distributed.nn.functional.all_gather`` would instead sum the
  group's output gradients, scaling every gradient by the model axis (on
  gloo it also emulates reduce-scatter with an all-to-all).

One process is one rank (``parallel/launch.py``); at world size 1 every
collective is skipped and the step is the single-device step.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dynslam_tpu_torch.device import DeviceLike, resolve_device
from dynslam_tpu_torch.models.dispnet import disparity_loss_terms
from dynslam_tpu_torch.models.layers import SameConv2d, conv_same

#: convs with at least this many output channels are split over "model"
MIN_SPLIT_CHANNELS = 64


def make_mesh(n: int, model_axis: int = 1,
              device: DeviceLike = None) -> DeviceMesh:
    """A ("data", "model") mesh over the ``n`` ranks of the current
    process group (``launch.group``/``spawn``) on ``device``'s type (CUDA
    unless the caller asks for the CPU)."""
    if n % model_axis:
        raise ValueError("make_mesh: n must divide by model_axis")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh: needs a process group of {n} ranks")
    return init_device_mesh(resolve_device(device).type,
                            (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _coord(mesh: DeviceMesh, dim: str):
    """(this rank's index along ``dim``, its size, its group)."""
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(
        dim)), mesh.get_group(dim)


class _GatherChannels(torch.autograd.Function):
    """All-gather channel slices along dim 1; backward: this rank's slice
    of the output gradient (the loss is replicated across the group)."""

    @staticmethod
    def forward(ctx, x, rank, size, group):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rank, ctx.c = rank, x.shape[1]
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.c, ctx.c), None, None, None


class _SumGradOverModel(torch.autograd.Function):
    """Identity; backward: all-reduce (sum) the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ColumnParallelConv(nn.Module):
    """A ``SameConv2d`` whose output channels are split over "model": this
    rank holds its slice of the weight and bias."""

    def __init__(self, conv: SameConv2d, mesh: DeviceMesh):
        super().__init__()
        self.rank, self.size, self.group = _coord(mesh, "model")
        out = conv.out_channels
        if out % self.size:
            raise ValueError(f"{out} channels do not split over "
                             f"{self.size} ranks")
        part = slice(self.rank * out // self.size,
                     (self.rank + 1) * out // self.size)
        self.weight = nn.Parameter(conv.weight.detach()[part].clone())
        self.bias = nn.Parameter(conv.bias.detach()[part].clone())
        self.stride = conv.stride[0]

    def forward(self, x):
        x = _SumGradOverModel.apply(x, self.group)
        y = conv_same(x, self.weight, self.bias, self.stride)
        return _GatherChannels.apply(y, self.rank, self.size, self.group)


def _splits(conv: nn.Module) -> bool:
    """``_param_spec``'s layout: a conv whose kernel (and bias) has >= 64
    output channels is split over "model"."""
    return isinstance(conv, SameConv2d) \
        and conv.out_channels >= MIN_SPLIT_CHANNELS


def shard_params(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    """A copy of ``model`` on this rank's device with the tensor-parallel
    layout: split convs hold their channel slice, the rest is replicated.
    With a model axis of 1 the copy holds every weight."""
    sharded = copy.deepcopy(model).to(mesh_device(mesh))
    if mesh.size(1) > 1:
        sharded.convs = nn.ModuleList(
            ColumnParallelConv(c, mesh) if _splits(c) else c
            for c in sharded.convs)
    return sharded


def gather_params(mesh: DeviceMesh, sharded: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """The whole ``state_dict`` of a ``shard_params`` module, on every
    rank (split convs' slices all-gathered over "model")."""
    out = {}
    for i, conv in enumerate(sharded.convs):
        for name in ("weight", "bias"):
            t = getattr(conv, name).detach()
            if isinstance(conv, ColumnParallelConv):
                parts = [torch.empty_like(t) for _ in range(conv.size)]
                dist.all_gather(parts, t.contiguous(), group=conv.group)
                t = torch.cat(parts, 0)
            out[f"convs.{i}.{name}"] = t.clone()
    return out


def shard_batch(mesh: DeviceMesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's share of every array's leading (batch) axis along
    "data", on its device."""
    rank, size, _ = _coord(mesh, "data")
    dev = mesh_device(mesh)

    def part(x):
        if x.shape[0] % size:
            raise ValueError(f"shard_batch: a batch of {x.shape[0]} does not "
                             f"split over {size} data ranks")
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n].to(dev)

    return {k: part(v) for k, v in batch.items()}


def _all_reduce(t: torch.Tensor, size: int, group) -> torch.Tensor:
    if size > 1:
        dist.all_reduce(t, group=group)
    return t


def make_sharded_train_step(mesh: DeviceMesh, model: nn.Module,
                            optimizer: torch.optim.Optimizer
                            ) -> Callable[[Dict[str, torch.Tensor]],
                                          torch.Tensor]:
    """``step(local_batch) -> loss``: DispNet-lite's train step on a
    ``shard_params`` module and an optimiser over its (local) parameters,
    fed ``shard_batch``'s share. Returns the global loss on every rank."""
    _, d_size, d_group = _coord(mesh, "data")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        err, n = disparity_loss_terms(model, batch["left"], batch["right"],
                                      batch["disparity"], batch["valid"])
        n = _all_reduce(n.detach().clone(), d_size, d_group)
        loss = err / torch.clamp(n, min=1.0)
        loss.backward()
        if d_size > 1:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=d_group)
            offset = 0
            for p in params:
                p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()
        optimizer.step()
        return _all_reduce(loss.detach(), d_size, d_group)

    return step


def make_sharded_apply(mesh: DeviceMesh, model: nn.Module
                       ) -> Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor]:
    """Data-parallel batched inference: ``run(left, right)`` on this rank's
    share of the batch returns the whole batch's disparity on every rank
    (all-gathered over "data")."""
    _, d_size, d_group = _coord(mesh, "data")

    def run(left, right):
        with torch.no_grad():
            disp = model(left, right)
        if d_size == 1:
            return disp
        parts = [torch.empty_like(disp) for _ in range(d_size)]
        dist.all_gather(parts, disp.contiguous(), group=d_group)
        return torch.cat(parts, 0)

    return run
