"""Tensor-parallel execution over the mesh's model axis: the port's
counterpart of the collectives GSPMD inserts around the parameters that
``parallel/mesh.py::tensor_parallel_spec`` partitions.

``tensor_parallel_model(model, mesh, family)`` returns a copy of ``model``
in which every partitioned layer is a twin holding only its slots' shards
(``shard_model_variables``), one shard on each device of a data row of the
mesh; the replicated layers stay on the row's first device (the lead),
where the input and the output live:

- a Linear cut on its outputs (the heads, the MLPs' first halves) is
  column-parallel: each slot computes its slice of the outputs, and the
  slices are concatenated on the lead;
- a conv cut on its output channels (ResNet's stage convs, DenseNet's,
  EfficientNet's and MobileNetV2's block convs) likewise, concatenated on
  channels before the replicated BatchNorm; a grouped conv gives each slot
  its groups' input channels;
- a Linear cut on its inputs (the MLPs' second halves, the attention
  output projections) is row-parallel: each slot multiplies its slice of
  the input, and the partial sums are added on the lead in slot order;
- ViT's attention runs each slot's heads on its device (the head-aligned
  qkv shard, the heads' attention, the row-parallel output projection) and
  adds the partial sums; Swin's qkv is column-parallel by heads and its
  output projection row-parallel around the replicated window attention.
  A slot's qkv rows are its heads' rows inside each of q, k and v, not a
  contiguous third of torch's packed ``[3D, D]``.

Every twin is built from torch ops, so autograd reaches the input (attacks)
and the shards (training).  The logits equal the replicated model's up to
float reassociation: the slices compute the same sums, and a row-parallel
layer adds n partial sums where one GEMM adds them all.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, PlacedVariable, shard_model_variables


def _param(t: torch.Tensor, requires_grad: bool) -> nn.Parameter:
    return nn.Parameter(t.detach().clone(), requires_grad=requires_grad)


def _add_in_order(partials: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    total = partials[0].to(lead)
    for p in partials[1:]:
        total = total + p.to(lead)
    return total


class _SlotModule(nn.Module):
    """Shards ``w0, w1, ...`` (and biases) as parameters, slot j's on
    ``devices[j]``."""

    def __init__(self, devices: list[torch.device]):
        super().__init__()
        self.devices = list(devices)
        self.shard_names: dict[str, int] = {}

    def _set(self, name: str, shards, requires_grad: bool) -> None:
        self.shard_names[name] = len(shards)
        for j, s in enumerate(shards):
            self.register_parameter(f"{name}{j}", _param(s, requires_grad))

    def _get(self, name: str) -> list[torch.Tensor]:
        return [getattr(self, f"{name}{j}") for j in range(self.shard_names[name])]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def weight(self) -> torch.Tensor:
        """The first slot's weight shard: the layer's dtype, which the
        models read (``self.fc.weight.dtype``)."""
        return self.weight0


class ColumnParallelLinear(_SlotModule):
    """``F.linear`` with the weight cut on its outputs; a bias either cut
    the same way or whole (added after the concatenation)."""

    def __init__(self, weights, bias_shards, bias, devices, requires_grad=False):
        super().__init__(devices)
        self._set("weight", weights, requires_grad)
        if bias_shards is not None:
            self._set("bias", bias_shards, requires_grad)
        self.full_bias = None if bias is None else _param(bias, requires_grad)
        self.cut_bias = bias_shards is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        biases = self._get("bias") if self.cut_bias else [None] * len(self.devices)
        outs = [F.linear(x.to(d), w, b) for d, w, b in zip(self.devices, self._get("weight"),
                                                            biases)]
        y = torch.cat([o.to(self.lead) for o in outs], dim=-1)
        return y if self.full_bias is None else y + self.full_bias


class RowParallelLinear(_SlotModule):
    """``F.linear`` with the weight cut on its inputs: each slot multiplies
    its slice of ``x``; the partial sums are added in slot order, then the
    (whole) bias."""

    def __init__(self, weights, bias, devices, requires_grad=False):
        super().__init__(devices)
        self._set("weight", weights, requires_grad)
        self.full_bias = None if bias is None else _param(bias, requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self._get("weight")
        xs = torch.split(x, [int(w.shape[1]) for w in ws], dim=-1)
        y = _add_in_order([F.linear(xi.to(d), w) for xi, d, w in zip(xs, self.devices, ws)],
                          self.lead)
        return y if self.full_bias is None else y + self.full_bias


class ColumnParallelConv2d(_SlotModule):
    """A conv with the kernel cut on its output channels, concatenated on
    channels.  With ``groups > 1`` each slot takes its groups' input
    channels (the slot count must divide the groups)."""

    def __init__(self, conv: nn.Conv2d, weights, bias_shards, devices, requires_grad=False):
        super().__init__(devices)
        n = len(weights)
        if conv.groups > 1 and conv.groups % n:
            raise ValueError(f"a conv of {conv.groups} groups does not split over {n} slots")
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups
        self._set("weight", weights, requires_grad)
        if bias_shards is not None:
            self._set("bias", bias_shards, requires_grad)
        self.cut_bias = bias_shards is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self._get("weight")
        n = len(ws)
        biases = self._get("bias") if self.cut_bias else [None] * n
        if self.groups > 1:
            xs = torch.chunk(x, n, dim=1)
            groups = self.groups // n
        else:
            xs, groups = [x] * n, 1
        outs = [F.conv2d(xi.to(d), w, b, self.stride, self.padding, self.dilation, groups)
                for xi, d, w, b in zip(xs, self.devices, ws, biases)]
        return torch.cat([o.to(self.lead) for o in outs], dim=1)


class HeadParallelQKV(_SlotModule):
    """A packed qkv projection (torch's ``[3D, D]``, rows (part, head,
    head_dim)) cut by heads, ``slot_heads`` a slot: slot j computes q, k and
    v of its heads; ``forward`` puts them back in the packed layout on the
    lead."""

    def __init__(self, weights, biases, slot_heads: int, devices, requires_grad=False):
        super().__init__(devices)
        self.slot_heads = int(slot_heads)
        self._set("weight", weights, requires_grad)
        self.cut_bias = biases is not None
        if biases is not None:
            self._set("bias", biases, requires_grad)

    def slot_outputs(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Each slot's ``[..., 3, H/n, hd]`` on its own device."""
        biases = self._get("bias") if self.cut_bias else [None] * len(self.devices)
        outs = []
        for d, w, b in zip(self.devices, self._get("weight"), biases):
            o = F.linear(x.to(d), w, b)
            outs.append(o.reshape(*o.shape[:-1], 3, self.slot_heads, -1))
        return outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([o.to(self.lead) for o in self.slot_outputs(x)], dim=-2)  # [..., 3, H, hd]
        return y.reshape(*y.shape[:-3], -1)


class TPSelfAttention(nn.Module):
    """ViT's attention with each slot's heads on its own device: the
    head-aligned qkv shard, ``softmax(q k^T / sqrt(hd)) v`` over those
    heads, and the output projection's rows for them; the slots' partial
    sums are added on the lead, then the bias."""

    def __init__(self, qkv: HeadParallelQKV, out_weights, out_bias, requires_grad=False):
        super().__init__()
        self.qkv = qkv
        self.out_proj = RowParallelLinear(out_weights, out_bias, qkv.devices, requires_grad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.vit import attention, merge_heads

        partials = []
        for j, o in enumerate(self.qkv.slot_outputs(x)):
            parts = o.permute(2, 0, 3, 1, 4)  # [3, B, H/n, T, hd]
            heads = merge_heads(attention(parts[0], parts[1], parts[2]))
            partials.append(F.linear(heads, self.out_proj._get("weight")[j]))
        y = _add_in_order(partials, self.qkv.lead)
        bias = self.out_proj.full_bias
        return y if bias is None else y + bias


def _check_plain(module: nn.Module, name: str, kinds) -> None:
    if type(module) not in kinds:
        raise ValueError(f"tensor parallelism runs float layers only: {name} is "
                         f"{type(module).__name__} (an int8 model cannot be cut)")


def _replace(root: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, child, new)


def tensor_parallel_model(model: nn.Module, mesh: Mesh, family: str, data_row: int = 0,
                          placed: dict[str, PlacedVariable] | None = None) -> nn.Module:
    """A copy of ``model`` whose partitioned layers are cut over the model
    axis of ``mesh``'s data row ``data_row``; the rest of the copy is moved
    to that row's first device.  ``family`` is the weight-layout family
    (``zoo.model_family``); ``placed`` reuses a ``shard_model_variables``
    result.  With a model axis of 1 the copy is the replicated model."""
    from ..models.vit import SelfAttention

    devices = list(mesh.devices[data_row])
    n_model = len(devices)
    placed = placed if placed is not None else shard_model_variables(
        model, mesh, tensor_parallel=True, family=family)
    row0 = data_row * n_model

    def slots(key: str) -> list[torch.Tensor]:
        return list(placed[key].shards[row0:row0 + n_model])

    def cut(key: str) -> bool:
        return key in placed and placed[key].spec is not None

    def whole(key: str) -> torch.Tensor | None:
        return placed[key].shards[row0] if key in placed else None

    tp = copy.deepcopy(model)
    if n_model == 1:
        return tp.to(devices[0])
    # the attention blocks first: a ViT block is one twin (heads per slot)
    for name, m in list(tp.named_modules()):
        if isinstance(m, SelfAttention) and cut(f"{name}.in_proj_weight"):
            if m.int8:
                raise ValueError(f"tensor parallelism runs float layers only: {name} is int8")
            out_key = f"{name}.out_proj.weight"
            if not (cut(f"{name}.in_proj_bias") and cut(out_key)):
                raise ValueError(f"{name}: the qkv bias and the output projection must be "
                                 "cut with the qkv kernel")
            rg = m.in_proj_weight.requires_grad
            qkv = HeadParallelQKV(slots(f"{name}.in_proj_weight"), slots(f"{name}.in_proj_bias"),
                                  placed[f"{name}.in_proj_weight"].heads // n_model, devices, rg)
            _replace(tp, name, TPSelfAttention(qkv, slots(out_key),
                                               whole(f"{name}.out_proj.bias"), rg))
    for name, m in list(tp.named_modules()):
        wkey, bkey = f"{name}.weight", f"{name}.bias"
        if not cut(wkey) or not isinstance(m, (nn.Linear, nn.Conv2d)):
            continue
        rg = m.weight.requires_grad
        pv = placed[wkey]
        bias_cut = slots(bkey) if cut(bkey) else None
        if isinstance(m, nn.Conv2d):
            _check_plain(m, name, (nn.Conv2d,))
            if m.bias is not None and bias_cut is None:
                twin = _ConvWithBias(ColumnParallelConv2d(m, slots(wkey), None, devices, rg),
                                     _param(whole(bkey), rg))
            else:
                twin = ColumnParallelConv2d(m, slots(wkey), bias_cut, devices, rg)
        elif pv.heads is not None:  # Swin's qkv Linear, cut by heads
            _check_plain(m, name, (nn.Linear,))
            twin = HeadParallelQKV(slots(wkey), bias_cut, pv.heads // n_model, devices, rg)
        elif pv.dim == 0:
            _check_plain(m, name, (nn.Linear,))
            twin = ColumnParallelLinear(slots(wkey), bias_cut,
                                        None if bias_cut is not None else whole(bkey),
                                        devices, rg)
        else:
            _check_plain(m, name, (nn.Linear,))
            twin = RowParallelLinear(slots(wkey), whole(bkey), devices, rg)
        _replace(tp, name, twin)
    # the rest of the copy lives on the lead device
    lead = devices[0]
    twins = [name for name, m in tp.named_modules() if isinstance(m, _SlotModule)]
    for name, m in tp.named_modules():
        if any(name == t or name.startswith(t + ".") for t in twins):
            continue
        for k, p in m._parameters.items():
            if p is not None:
                m._parameters[k] = nn.Parameter(p.data.to(lead), requires_grad=p.requires_grad)
        for k, b in m._buffers.items():
            if b is not None:
                m._buffers[k] = b.to(lead)
    return tp


class _ConvWithBias(nn.Module):
    """A column-parallel conv whose bias the rule leaves whole."""

    def __init__(self, conv: ColumnParallelConv2d, bias: nn.Parameter):
        super().__init__()
        self.conv, self.bias = conv, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + self.bias.view(1, -1, 1, 1).to(y.dtype)


def shard_fractions(model_tp: nn.Module, model: nn.Module) -> dict[str, float]:
    """Per twin: the elements of one slot's weight shard over the whole
    weight's (1/n_model when the layer is cut)."""
    full = dict(model.named_parameters())
    out = {}
    for name, m in model_tp.named_modules():
        if isinstance(m, HeadParallelQKV) and name.endswith(".qkv") and \
                f"{name[:-4]}.in_proj_weight" in full:
            out[name[:-4] + ".in_proj_weight"] = m.weight0.numel() / full[
                f"{name[:-4]}.in_proj_weight"].numel()
        elif isinstance(m, _SlotModule) and f"{name}.weight" in full:
            out[f"{name}.weight"] = m.weight0.numel() / full[f"{name}.weight"].numel()
        elif isinstance(m, ColumnParallelConv2d) and name.endswith(".conv"):
            out[f"{name[:-5]}.weight"] = m.weight0.numel() / full[f"{name[:-5]}.weight"].numel()
    return out
