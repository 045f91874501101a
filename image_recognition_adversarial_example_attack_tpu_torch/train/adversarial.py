"""Adversarial and certified training (port of ``train/adversarial.py``):
PGD-AT (Madry et al., ICLR 2018) with SmoothAdv / Cohen noise, free-AT
(Shafahi et al. 2019), TRADES (Zhang et al. 2019), MART (Wang et al. 2020)
and IBP / CROWN-IBP (Gowal et al. 2018; Zhang et al. 2020), with gradient
accumulation, rematerialization, augmentation, a parameter EMA, exact
checkpoints and precise-BN calibration.

A step is ``(state, x01, y, generator) -> (state, metrics)``:

    PGD on the current parameters     (``steps`` input gradients)
    the adversarial batch as data     (no graph kept)
    the loss's parameter gradients    (one forward + backward)
    one AdamW update (train/optim.py) and the EMA

The state keeps float32 master parameters (``params``; float64 stays
float64) keyed by the module's state-dict names, the buffers
(``extra_variables``: BatchNorm's running statistics), AdamW's moments,
the step and the EMA.  Every forward runs the state's module through
``torch.func.functional_call`` on copies of the masters cast to the
module's compute dtypes (bfloat16 convs and GEMMs in a bf16 model, float32
BatchNorm), as the JAX package's modules cast their float32 parameters at
each use; the gradients reach the float32 masters through the casts.  The
inner maximization runs on detached parameters, so its input gradients
build no parameter graph.  Logits are cast to float32, as in the JAX
package, whatever the model's dtype.

The PGD updates go through the ``pgd_step`` kernel (``attacks/pgd.py``, and
TRADES's inner loop, which computes the same function) and the PGD start
through the noise kernel; the rest is plain torch, as it is XLA in the JAX
package.  On a CPU tensor the kernels' plain versions run.

Randomness: each step takes one ``torch.Generator`` (the training CLI seeds
it from ``(seed, epoch, step)`` alone, so a resumed run replays the
schedule) and splits it as the JAX step splits its key.  Each draw goes
through one function: the PGD start ``attacks.pgd.draw_start``, TRADES's
normal ``draw_trades_start``, Cohen's noise ``draw_cohen_noise``, the EOT
seed and noise ``attacks.eot.seed_draw`` / ``draw_noise``, the augmentation
``train.augment.draw_augment``.

With ``train_bn`` (the CIFAR families) every forward of the step, the
inner attack's and the eval steps' included, normalizes by the batch's own
statistics (``models.resnet.TrainableBatchNorm2d``), and
``calibrate_batch_stats`` computes the running statistics once at export.

Every step also takes a batch sharded over a mesh's data axis
(``parallel.mesh.ShardedTensor``; the JAX step jitted with the batch over
'data'): each shard's forward and backward run on its device, its means
divide by the whole (micro-)batch's row count, its draws are its rows of
the unsharded step's (``core.rng.shard_generators``), and the gradients are
summed over the shards and then the processes before one AdamW update.
``grad_accum``'s micro-batches are the unsharded step's, each split evenly
over every data row.  Under ``train_bn`` the shards run in lockstep threads
(``parallel/collective.py``) so that every forward normalizes by the whole
batch's statistics; under remat the recomputed forward reads the sums its
first run made (``collective.checkpoint_contexts``).  SmoothAdv's shards
also run in lockstep: each EOT call meets the other shards for the whole
batch's input mix (``attacks/eot.py``).
"""

from __future__ import annotations

import copy
import os
import weakref
from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path
from types import SimpleNamespace
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..attacks import pgd
from ..attacks.eot import make_eot_logits_fn
from ..core.constants import IMAGENET_MEAN, IMAGENET_STD
from ..core.normalize import normalize_batch
from ..core.rng import shard_generators, split_generators, standard_normal
from ..kernels import elementwise
from ..models.resnet import TrainableBatchNorm2d, batch_moments, set_train_bn
from ..parallel import collective
from ..parallel.collective import batch_rows, run_lockstep, shard_context, shard_grad
from ..parallel.distributed import all_gather_rows, all_reduce_sum, process_count
from ..parallel.mesh import ShardedTensor
from .augment import AugmentConfig, make_augment_fn
from .optim import AdamState, AdamW, global_norm, make_lr_schedule

# The dtype of the step's logits, losses, EMA and IBP ramp: float32 whatever
# the model's dtype, as the JAX package's step casts them.
LOSS_DTYPE = torch.float32


@dataclass(frozen=True)
class AdvTrainConfig:
    """The training step's configuration: the JAX package's fields and
    defaults."""

    eps: float = 8 / 255
    alpha: float = 2 / 255
    attack_steps: int = 7          # Madry's PGD-7
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    label_smoothing: float = 0.0
    clean_weight: float = 0.0      # >0: mixes clean CE into the PGD-AT loss
    trades_beta: float = 6.0
    mart_beta: float = 5.0
    # >0: SmoothAdv inner attack on the EOT-smoothed model and Cohen's
    # noisy CE; with attack_steps=0, plain Gaussian augmentation
    noise_sigma: float = 0.0
    noise_samples: int = 4
    grad_accum: int = 1            # equal micro-batches, one update
    remat: bool = False            # recompute activations in the backward
    lr_schedule: str = "constant"  # or "cosine" (warmup + cosine decay)
    warmup_steps: int = 0
    total_steps: int = 0           # required (>0) for 'cosine'
    free_replays: int = 4          # the free objective's replays per batch
    train_bn: bool = False         # batch-statistics BatchNorm (CIFAR family)
    ibp_ramp_steps: int = 0        # eps 0 -> eps, kappa 1 -> ibp_kappa
    ibp_kappa: float = 0.5
    ibp_bound: str = "ibp"         # or "crown" (CROWN-IBP)
    ibp_final_beta: float = 0.0
    aug_pad: int = 0
    aug_flip: bool = False
    aug_cutout: int = 0
    ema_decay: float = 0.0         # >0: EMA of the parameters, deployed


@dataclass
class TrainState:
    """Master parameters, buffers, optimizer state, step and EMA, with the
    module that runs the forward (``model``, the JAX state's ``apply_fn``)
    and each parameter's dtype in that forward (``compute_dtypes``)."""

    params: dict[str, torch.Tensor]
    extra_variables: dict[str, torch.Tensor]
    opt_state: AdamState
    step: int
    tx: AdamW
    model: nn.Module
    compute_dtypes: dict[str, torch.dtype]
    input_dtype: torch.dtype
    ema_params: dict[str, torch.Tensor] | None = None
    train_bn: bool = False

    def replace(self, **kw) -> "TrainState":
        return replace(self, **kw)


def train_state_from_bundle(bundle, config: AdvTrainConfig,
                            compute_dtype: torch.dtype | None = None) -> TrainState:
    """A TrainState from a zoo ``ModelBundle`` (``models/zoo.py``).

    The bundle's weights become the master parameters (float32, or float64
    for a float64 model): load it in float32 and pass ``compute_dtype`` (for
    example bfloat16) for the forward, so that the masters are not rounded.
    The state takes over the bundle's module: it sets its compute dtype and,
    with ``config.train_bn``, puts its BatchNorms in batch-statistics mode
    (Flax's ``module.clone(train_bn=True)``), else in running-statistics
    mode; a family without ``train_bn`` refuses it with ValueError."""
    from ..models.zoo import set_compute_dtype

    model = bundle.model
    if hasattr(model, "train_bn"):
        set_train_bn(model, config.train_bn)
    elif config.train_bn:
        raise ValueError(
            f"model '{bundle.name}' does not support train_bn "
            "(from-scratch BN training is a CIFAR-family feature; "
            "the ImageNet families fine-tune with frozen statistics)")
    params = {k: v.detach().to(torch.promote_types(v.dtype, torch.float32)).clone()
              for k, v in model.named_parameters()}
    extra = {k: v.detach().clone() for k, v in model.named_buffers()}
    dtype = bundle.dtype if compute_dtype is None else compute_dtype
    if dtype == torch.float64:
        model.double()  # a float64 model: BatchNorm in float64 too
    else:
        set_compute_dtype(model, dtype)
    tx = AdamW(make_lr_schedule(config), weight_decay=config.weight_decay)
    return TrainState(
        params=params, extra_variables=extra, opt_state=tx.init(params), step=0, tx=tx,
        model=model, compute_dtypes={k: v.dtype for k, v in model.named_parameters()},
        input_dtype=dtype,
        ema_params=({k: v.clone() for k, v in params.items()}
                    if config.ema_decay > 0.0 else None),
        train_bn=bool(config.train_bn))


def train_state_from_jax(template: TrainState, family: str, *, params, extra_variables,
                         mu, nu, count: int, step: int, ema_params=None) -> TrainState:
    """The port's TrainState holding a JAX TrainState's arrays (numpy trees
    in Flax's layout: ``params``, ``extra_variables`` such as
    ``{"batch_stats": ...}``, adam's ``mu`` / ``nu`` / ``count``, ``step``,
    the EMA), carried through ``models.convert.from_jax_variables`` for the
    weight-layout ``family``; ``template`` gives the module, the optimizer,
    the dtypes and the device."""
    from ..models.convert import from_jax_variables

    def tree(ps):
        sd = from_jax_variables({"params": ps}, family)
        return {k: sd[k].to(device=template.params[k].device, dtype=template.params[k].dtype)
                for k in template.params}

    full = from_jax_variables({"params": params, **dict(extra_variables)}, family)
    extra = {k: full[k].to(device=v.device, dtype=v.dtype)
             for k, v in template.extra_variables.items()}
    return template.replace(
        params=tree(params), extra_variables=extra,
        opt_state=AdamState(int(count), tree(mu), tree(nu)), step=int(step),
        ema_params=None if ema_params is None else tree(ema_params))


def _mean_rows(t: torch.Tensor) -> torch.Tensor:
    """The mean over the batch's rows of a per-row tensor: ``torch.mean``,
    or, in a shard of a sharded step, the shard's sum over the whole
    (micro-)batch's row count, so that the shards' values add up to the
    unsharded mean."""
    rows = batch_rows()
    return torch.mean(t) if rows is None else torch.sum(t) / (rows * (t.numel() // t.shape[0]))


def _ce_loss(logits: torch.Tensor, y: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Mean cross-entropy; with ``smoothing`` against optax.smooth_labels'
    ``(1 - a) * onehot + a / n``."""
    logp = F.log_softmax(logits, dim=-1)
    if smoothing > 0.0:
        n = logits.shape[-1]
        target = (1.0 - smoothing) * F.one_hot(y.long(), n).to(logp.dtype) + smoothing / n
        return -_mean_rows(torch.sum(target * logp, dim=-1))
    return -_mean_rows(logp.gather(-1, y.long()[:, None]))


def _accuracy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _mean_rows((torch.argmax(logits, dim=-1) == y).to(LOSS_DTYPE))


def _finish_step(state: TrainState, grads, metrics, ema_decay: float = 0.0):
    """The tail of every objective: one AdamW update, the EMA (in float32)
    and ``grad_norm`` of the gradient the optimizer consumed."""
    params, opt_state = state.tx.update(grads, state.opt_state, state.params)
    new_state = state.replace(params=params, opt_state=opt_state, step=state.step + 1)
    if state.ema_params is not None and ema_decay > 0.0:
        # the float32 decay and its complement, made once on the parameters' device
        d = torch.tensor(ema_decay, dtype=LOSS_DTYPE,
                         device=next(iter(params.values())).device)
        keep = 1.0 - d
        new_state.ema_params = {
            k: (d * e.to(LOSS_DTYPE) + keep * params[k].to(LOSS_DTYPE)).to(e.dtype)
            for k, e in state.ema_params.items()}
    metrics = dict(metrics)
    metrics["grad_norm"] = global_norm(grads)
    return new_state, metrics


def _param_grads(total_loss: Callable, params: dict[str, torch.Tensor], *extra_inputs):
    """(loss, aux, parameter grads[, grads of ``extra_inputs``]) of
    ``total_loss(leaves, *extra_inputs) -> (loss, aux)``, aux detached."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, aux = total_loss(leaves, *extra_inputs)
        grads = shard_grad(loss, [*leaves.values(), *extra_inputs],
                           allow_unused=True, materialize_grads=True)
    aux = tuple(a.detach() for a in aux) if isinstance(aux, tuple) else aux.detach()
    g = dict(zip(leaves, grads[:len(leaves)]))
    return (loss.detach(), aux, g, *grads[len(leaves):])


def _augment_fn(config: AdvTrainConfig):
    return make_augment_fn(AugmentConfig(pad=int(config.aug_pad), flip=bool(config.aug_flip),
                                         cutout=int(config.aug_cutout)))


def _with_augment(grads_fn, config: AdvTrainConfig):
    """Augment the whole batch (before any micro-batching) from the first
    of two generators split off the step's; an empty policy returns
    ``grads_fn`` unchanged and splits nothing."""
    augment = _augment_fn(config)
    if augment is None:
        return grads_fn

    def fn(state, x01, y, generator):
        g_aug, generator = split_generators(generator, 2)
        return grads_fn(state, augment(g_aug, x01), y, generator)

    return fn


def _with_grad_accum(grads_fn, accum: int):
    """``grads_fn`` over ``accum`` equal micro-batches, one after another,
    each with its own generator split off the step's (and, under
    ``train_bn``, its own batch statistics): the mean of the gradients and
    of the metrics.  A batch ``accum`` does not divide raises ValueError."""
    if accum <= 1:
        return grads_fn

    def accum_fn(state, x01, y, generator):
        b = int(x01.shape[0])
        if b % accum:
            raise ValueError(f"batch size {b} is not divisible by grad_accum={accum}")
        micro = b // accum
        g_sum = m_sum = None
        for i, g in enumerate(split_generators(generator, accum)):
            sl = slice(i * micro, (i + 1) * micro)
            grads, metrics = grads_fn(state, x01[sl], y[sl], g)
            if g_sum is None:
                g_sum, m_sum = grads, metrics
            else:
                g_sum = {k: g_sum[k] + v for k, v in grads.items()}
                m_sum = {k: m_sum[k] + v for k, v in metrics.items()}
        inv = 1.0 / accum
        return {k: t * inv for k, t in g_sum.items()}, {k: t * inv for k, t in m_sum.items()}

    return accum_fn


def _cast(state: TrainState, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The masters in the forward's dtypes (no copy where they already are)."""
    return {k: v.to(state.compute_dtypes[k]) for k, v in params.items()}


def _apply_model(state: TrainState, params: dict[str, torch.Tensor],
                 x_norm: torch.Tensor) -> torch.Tensor:
    """One forward of the state's module on a normalized NHWC batch with
    ``params`` and the buffers; under ``train_bn`` it normalizes by batch
    statistics and leaves the buffers as they are."""
    tensors = {**_cast(state, params), **state.extra_variables}
    x = x_norm.to(state.input_dtype).permute(0, 3, 1, 2)
    return functional_call(state.model, tensors, (x,))


def _make_apply_logits(config: AdvTrainConfig, mean, std):
    """``(state, params, x01) -> float32 logits``; under ``config.remat``
    the forward is checkpointed (``use_reentrant=False``): every backward
    recomputes its activations, in a lockstep shard from the batch
    statistics its first run summed (``collective.checkpoint_contexts``)."""

    def apply_logits(state: TrainState, params, x01):
        def fwd(x01):
            return _apply_model(state, params, normalize_batch(x01, mean, std)).to(LOSS_DTYPE)

        if config.remat:
            return checkpoint(fwd, x01, use_reentrant=False,
                              context_fn=collective.checkpoint_contexts)
        return fwd(x01)

    return apply_logits


def draw_trades_start(shape, generator: torch.Generator,
                      device: torch.device | str) -> torch.Tensor:
    """TRADES's start: N(0, 1) float32 of ``shape`` (scaled by 0.001)."""
    return standard_normal(shape, generator, device)


def draw_cohen_noise(shape, generator: torch.Generator,
                     device: torch.device | str) -> torch.Tensor:
    """Cohen et al.'s training noise: N(0, 1) float32 of ``shape`` (scaled
    by ``noise_sigma``)."""
    return standard_normal(shape, generator, device)


def _step_with(grads_fn, config: AdvTrainConfig):
    grads_full = _with_augment(_with_grad_accum(grads_fn, int(config.grad_accum)), config)

    def step(state: TrainState, x01, y, generator):
        if isinstance(x01, ShardedTensor):
            grads = _sharded_grads(grads_fn, config, state, x01, y, generator)
        else:
            grads = grads_full(state, x01, y, generator)
        return _finish_step(state, *grads, ema_decay=config.ema_decay)

    return step


# ---------------------------------------------------------------------------
# A step over a data-sharded batch (the JAX step jitted with the batch
# sharded over 'data'): each shard's forward and backward on its device, the
# gradients summed over the shards and then the processes, one update.
# ---------------------------------------------------------------------------

# metrics that are no mean over rows (every shard reports the same value)
_SHARED_METRICS = ("ibp_eps", "ibp_kappa")
_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def _replica(model: nn.Module, device: torch.device, index: int) -> nn.Module:
    """A copy of ``model`` on ``device`` for shard ``index`` (``model`` itself
    for shard 0 on its own device), kept for later steps: shards that run
    at once (``train_bn``) each need their own module for
    ``functional_call``."""
    home = next(iter(model.parameters())).device
    if index == 0 and device == home:
        return model
    cache = _REPLICAS.setdefault(model, {})
    key = (str(device), index)
    if key not in cache:
        cache[key] = copy.deepcopy(model).to(device)
    return cache[key]


def _state_on(state: TrainState, device: torch.device, index: int) -> TrainState:
    """The state as shard ``index`` on ``device`` uses it (no copy for shard
    0 on the state's device)."""
    home = next(iter(state.params.values())).device
    if index == 0 and device == home:
        return state
    return state.replace(params={k: v.to(device) for k, v in state.params.items()},
                         extra_variables={k: v.to(device)
                                          for k, v in state.extra_variables.items()},
                         model=_replica(state.model, device, index))


def _run_shards(state: TrainState, devices, rows: int, fn, lockstep: bool = False) -> list:
    """``fn(shard_state, i)`` for every shard i (its batch of ``rows`` rows
    the whole (micro-)batch): one after another when the shards are
    independent, in lockstep threads under ``train_bn`` or ``lockstep``
    (the shards exchange their EOT mixes)."""
    cross = process_count() > 1
    if state.train_bn or lockstep:
        return run_lockstep([partial(fn, _state_on(state, d, i), i) for i, d in enumerate(devices)],
                            rows, cross_process=cross)
    out = []
    for i, d in enumerate(devices):
        # the same module serves every shard of one device, one at a time
        with shard_context(None, i, rows):
            out.append(fn(_state_on(state, d, 0), i))
    return out


def _reduce_tree(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Each tensor summed over the processes (one all_reduce a dtype)."""
    if process_count() == 1:
        return tree
    groups: dict = {}
    for k, v in tree.items():
        groups.setdefault((v.dtype, v.device), []).append(k)
    out = {}
    for keys in groups.values():
        flat = all_reduce_sum(torch.cat([tree[k].reshape(-1) for k in keys]))
        for k, part in zip(keys, torch.split(flat, [tree[k].numel() for k in keys])):
            out[k] = part.reshape(tree[k].shape)
    return out


def _sum_shards(results, home: torch.device):
    """Per-shard (grads, metrics) -> their sums, in shard order on ``home``,
    then over the processes; the shared metrics are shard 0's."""
    grads = {k: v.to(home) for k, v in results[0][0].items()}
    metrics = {k: v.to(home) for k, v in results[0][1].items()}
    for g, m in results[1:]:
        grads = {k: t + g[k].to(home) for k, t in grads.items()}
        metrics = {k: t if k in _SHARED_METRICS else t + m[k].to(home)
                   for k, t in metrics.items()}
    shared = {k: metrics.pop(k) for k in _SHARED_METRICS if k in metrics}
    return _reduce_tree(grads), {**_reduce_tree(metrics), **shared}


def _micro_pieces(x: ShardedTensor, xs, ys, micro: int, accum: int):
    """The micro-batches of a sharded batch, each split evenly over every
    data row of the mesh (every process's), as the unsharded step splits
    the batch: for micro-batch i, this process's pieces (x, y, rows within
    the micro-batch) on its devices.  Several processes first gather the
    whole batch (``all_gather_rows``)."""
    mesh = x.sharding.mesh
    n_rows = mesh.shape["data"]
    if micro < n_rows:
        raise ValueError(f"a micro-batch of {micro} rows leaves some of the {n_rows} data "
                         "shards empty")
    home = xs[0].device
    x_all = all_gather_rows(torch.cat([t.to(home) for t in xs]))
    y_all = all_gather_rows(torch.cat([t.to(home) for t in ys]))
    devices = [row[0] for row in mesh.devices]
    edges = [0]
    for c in torch.tensor_split(torch.arange(micro), n_rows):
        edges.append(edges[-1] + int(c.numel()))
    out = []
    for i in range(accum):
        pieces = []
        for j, d in enumerate(devices):
            k = mesh.first_data_row + j
            a, b = i * micro + edges[k], i * micro + edges[k + 1]
            pieces.append((x_all[a:b].to(d), y_all[a:b].to(d), (edges[k], edges[k + 1])))
        out.append(pieces)
    return out


def _sharded_grads(grads_fn, config: AdvTrainConfig, state: TrainState, x: ShardedTensor, y,
                   generator: torch.Generator):
    """The unsharded ``grads_full`` (augment, grad_accum, ``grads_fn``) over
    a data-sharded batch, equal to it up to float reassociation: every draw
    is the unsharded run's rows (``core.rng.shard_generators``), every mean
    divides by the whole (micro-)batch's rows, and under ``train_bn`` the
    batch statistics are the whole (micro-)batch's."""
    from ..parallel.data_parallel import shard_labels

    y = shard_labels(y, x.sharding.mesh)
    xs, ys, ranges = x.data_shards(), y.data_shards(), x.row_ranges()
    total = int(x.shape[0])
    home = next(iter(state.params.values())).device
    augment = _augment_fn(config)
    if augment is not None:
        g_aug, generator = split_generators(generator, 2)
        xs = [augment(g, xi) for g, xi in zip(shard_generators(g_aug, ranges, total), xs)]

    def one_pass(pieces, rows: int, gen: torch.Generator):
        gens = shard_generators(gen, [r for _, _, r in pieces], rows)
        results = _run_shards(state, [p[0].device for p in pieces], rows,
                              lambda st, i: grads_fn(st, pieces[i][0], pieces[i][1], gens[i]),
                              lockstep=config.noise_sigma > 0.0 and config.attack_steps > 0)
        return _sum_shards(results, home)

    accum = int(config.grad_accum)
    if accum <= 1:
        return one_pass(list(zip(xs, ys, ranges)), total, generator)
    if total % accum:
        raise ValueError(f"batch size {total} is not divisible by grad_accum={accum}")
    micro = total // accum
    g_sum = m_sum = None
    for pieces, g in zip(_micro_pieces(x, xs, ys, micro, accum),
                         split_generators(generator, accum)):
        grads, metrics = one_pass(pieces, micro, g)
        if g_sum is None:
            g_sum, m_sum = grads, metrics
        else:
            g_sum = {k: g_sum[k] + v for k, v in grads.items()}
            m_sum = {k: m_sum[k] + v for k, v in metrics.items()}
    inv = 1.0 / accum
    return {k: t * inv for k, t in g_sum.items()}, {k: t * inv for k, t in m_sum.items()}


def make_train_step(config: AdvTrainConfig, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """One PGD-AT step: ``(state, x01, y, generator) -> (state, metrics)``.

    ``x01`` is a [B,H,W,C] batch in [0,1] (normalized inside).  With
    ``noise_sigma`` the attack runs on the EOT-smoothed model (SmoothAdv)
    and the loss on a noisy draw (Cohen); ``attack_steps=0`` is no attack
    and no random start.  ``clean_weight`` mixes the clean CE in."""
    apply_logits = _make_apply_logits(config, mean, std)

    def grads_fn(state: TrainState, x01, y, generator):
        g_attack, g_eot, g_noise = split_generators(generator, 3)
        frozen = _cast(state, state.params)

        def logits_fn(xx):
            return apply_logits(state, frozen, xx)

        if config.attack_steps > 0:
            attack_fn = (make_eot_logits_fn(logits_fn, g_eot, n_samples=config.noise_samples,
                                            sigma=config.noise_sigma)
                         if config.noise_sigma > 0.0 else logits_fn)
            x_adv = pgd.pgd_linf_attack(attack_fn, x01, y, eps=config.eps, alpha=config.alpha,
                                        steps=config.attack_steps, generator=g_attack)
        else:
            x_adv = x01
        if config.noise_sigma > 0.0:
            x_train = x_adv + config.noise_sigma * draw_cohen_noise(
                x_adv.shape, g_noise, x_adv.device).to(x_adv.dtype)
        else:
            x_train = x_adv

        def total_loss(params):
            adv_logits = apply_logits(state, params, x_train)
            loss = _ce_loss(adv_logits, y, config.label_smoothing)
            if config.clean_weight > 0.0:
                clean = _ce_loss(apply_logits(state, params, x01), y, config.label_smoothing)
                loss = (1.0 - config.clean_weight) * loss + config.clean_weight * clean
            return loss, adv_logits

        loss, adv_logits, grads = _param_grads(total_loss, state.params)
        return grads, {"loss": loss, "adv_accuracy": _accuracy(adv_logits, y)}

    return _step_with(grads_fn, config)


def make_free_step(config: AdvTrainConfig, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Free adversarial training: ``(state, x01, y, generator, delta) ->
    (state, metrics, delta)``.  The batch is replayed ``free_replays``
    times; each replay takes the parameter and the input gradient from one
    backward, makes a full optimizer update and moves the carried
    perturbation one FGSM step, ``clip(d + eps*sign(g_x), -eps, eps)``.
    The caller carries ``delta`` [B,H,W,C] across batches (zeros first);
    the batch is augmented once.  The metrics are the replays' means."""
    if int(config.grad_accum) > 1:
        raise ValueError("free objective updates parameters every replay; "
                         "grad_accum does not compose with it")
    apply_logits = _make_apply_logits(config, mean, std)
    m = max(1, int(config.free_replays))
    augment = _augment_fn(config)

    def step(state: TrainState, x01, y, generator, delta):
        # a plain batch is one shard; a sharded one replays every shard's
        # rows, its gradients summed before each update (``delta`` sharded
        # as ``x01``, or a host/one-device [B,H,W,C] tensor split the same way)
        sharded = isinstance(x01, ShardedTensor)
        if sharded:
            from ..parallel.data_parallel import like, shard_labels

            mesh = x01.sharding.mesh
            y = shard_labels(y, mesh)
            delta = delta if isinstance(delta, ShardedTensor) else shard_labels(delta, mesh)
            xs, ys, ranges = x01.data_shards(), y.data_shards(), x01.row_ranges()
            ds = [d.to(xi.device) for d, xi in zip(delta.data_shards(), xs)]
            gens = shard_generators(generator, ranges, int(x01.shape[0]))
        else:
            xs, ys, ds, gens = [x01], [y], [delta], [generator]
        if augment is not None:
            xs = [augment(g, xi) for g, xi in zip(gens, xs)]
        home = next(iter(state.params.values())).device
        history = []
        for _ in range(m):
            def shard(st, i):
                x_adv = torch.clamp(xs[i] + ds[i], 0.0, 1.0).requires_grad_(True)

                def loss_wrt(params, xx):
                    logits = apply_logits(st, params, xx)
                    return _ce_loss(logits, ys[i], config.label_smoothing), logits

                loss, logits, g_p, g_x = _param_grads(loss_wrt, st.params, x_adv)
                return (g_p, {"loss": loss, "adv_accuracy": _accuracy(logits, ys[i])}), g_x

            if sharded:
                results = _run_shards(state, [xi.device for xi in xs], int(x01.shape[0]), shard)
                g_p, metrics = _sum_shards([r[0] for r in results], home)
            else:
                results = [shard(state, 0)]
                g_p, metrics = results[0][0]
            state, metrics = _finish_step(state, g_p, metrics, ema_decay=config.ema_decay)
            ds = [torch.clamp(d + config.eps * torch.sign(r[1]), -config.eps, config.eps)
                  for d, r in zip(ds, results)]
            history.append(metrics)
        return state, {k: torch.mean(torch.stack([h[k] for h in history]))
                       for k in history[0]}, like(x01, ds) if sharded else ds[0]

    return step


def make_trades_step(config: AdvTrainConfig, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """One TRADES step: ``CE(f(x), y) + beta * KL(f(x) || f(x_adv))``, with
    x_adv maximizing the KL in the eps-ball (the clean distribution fixed),
    started at ``clip(x + 0.001 * N(0, I), 0, 1)``.  Each inner update is
    ``pgd_step``'s function and runs through its kernel."""
    apply_logits = _make_apply_logits(config, mean, std)

    def grads_fn(state: TrainState, x01, y, generator):
        frozen = _cast(state, state.params)
        with torch.no_grad():
            p_clean = torch.softmax(apply_logits(state, frozen, x01), dim=-1)
        logp_clean = torch.log(torch.clamp_min(p_clean, 1e-12))
        x0 = x01.contiguous()
        x_adv = torch.clamp(
            x0 + 0.001 * draw_trades_start(x0.shape, generator, x0.device).to(x0.dtype), 0.0, 1.0)
        for _ in range(int(config.attack_steps)):
            xg = x_adv.detach().requires_grad_(True)
            with torch.enable_grad():
                logp_adv = F.log_softmax(apply_logits(state, frozen, xg), dim=-1)
                (g,) = shard_grad(torch.sum(p_clean * (logp_clean - logp_adv)), [xg])
            x_adv = elementwise.pgd_step(x_adv.contiguous(), g.contiguous(), x0,
                                         config.eps, config.alpha)

        def total_loss(params):
            logits_clean = apply_logits(state, params, x01)
            logits_adv = apply_logits(state, params, x_adv)
            natural = _ce_loss(logits_clean, y, config.label_smoothing)
            p = torch.softmax(logits_clean, dim=-1)
            logp = F.log_softmax(logits_clean, dim=-1)
            logq = F.log_softmax(logits_adv, dim=-1)
            robust = _mean_rows(torch.sum(p * (logp - logq), dim=-1))
            return natural + config.trades_beta * robust, (natural, robust, logits_adv)

        loss, (natural, robust, adv_logits), grads = _param_grads(total_loss, state.params)
        return grads, {"loss": loss, "natural_loss": natural, "robust_kl": robust,
                       "adv_accuracy": _accuracy(adv_logits, y)}

    return _step_with(grads_fn, config)


def make_mart_step(config: AdvTrainConfig, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """One MART step: the boosted CE ``-log p_y(x_adv) - log(1 - max_{k!=y}
    p_k(x_adv))`` plus ``beta * KL(p(x) || p(x_adv)) * (1 - p_y(x))`` per
    sample, on PGD-on-CE examples."""
    apply_logits = _make_apply_logits(config, mean, std)

    def grads_fn(state: TrainState, x01, y, generator):
        frozen = _cast(state, state.params)
        x_adv = pgd.pgd_linf_attack(lambda xx: apply_logits(state, frozen, xx), x01, y,
                                    eps=config.eps, alpha=config.alpha,
                                    steps=config.attack_steps, generator=generator)

        def total_loss(params):
            logits_adv = apply_logits(state, params, x_adv)
            logits_clean = apply_logits(state, params, x01)
            oh = F.one_hot(y.long(), logits_adv.shape[-1]).to(logits_adv.dtype)
            p_adv = torch.softmax(logits_adv, dim=-1)
            py_adv = torch.sum(p_adv * oh, dim=-1)
            top_other = torch.max(p_adv - oh, dim=-1).values
            bce = _mean_rows(-torch.log(torch.clamp_min(py_adv, 1e-12))
                             - torch.log(torch.clamp_min(1.0 - top_other, 1e-12)))
            p_clean = torch.softmax(logits_clean, dim=-1)
            logp_clean = torch.log(torch.clamp_min(p_clean, 1e-12))
            logq_adv = F.log_softmax(logits_adv, dim=-1)
            kl = torch.sum(p_clean * (logp_clean - logq_adv), dim=-1)
            reg = _mean_rows(kl * (1.0 - torch.sum(p_clean * oh, dim=-1)))
            return bce + config.mart_beta * reg, (bce, reg, logits_adv)

        loss, (bce, reg, adv_logits), grads = _param_grads(total_loss, state.params)
        return grads, {"loss": loss, "bce_loss": bce, "weighted_kl": reg,
                       "adv_accuracy": _accuracy(adv_logits, y)}

    return _step_with(grads_fn, config)


def ibp_layers(params: dict[str, torch.Tensor], spec: tuple) -> dict[str, SimpleNamespace]:
    """The interval propagators' view (``models.ibp.ibp_params``) of a
    state's parameters: layer name -> an object with ``weight`` and
    ``bias``."""
    names = [f"{'conv' if layer[0] == 'conv' else 'dense'}_{i}"
             for i, layer in enumerate(spec) if layer[0] in ("conv", "dense")]
    return {n: SimpleNamespace(weight=params[f"{n}.weight"], bias=params[f"{n}.bias"])
            for n in names}


def make_ibp_step(config: AdvTrainConfig, spec: tuple, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """IBP certified training: ``kappa_t*CE(clean) + (1-kappa_t)*CE(worst
    case at eps_t)``, the bounds from ``defenses/ibp.py`` or, with
    ``ibp_bound="crown"``, the margins ``beta_t*CROWN + (1-beta_t)*IBP``
    from ``defenses/crown_ibp.py``.  eps_t, kappa_t and beta_t ramp with
    ``state.step`` over ``ibp_ramp_steps``, in float32 as in the JAX
    package.  The generator is taken and unused (IBP draws nothing)."""
    from ..defenses.crown_ibp import margin_spec_bounds
    from ..defenses.ibp import logit_bounds, spec_forward, verified_margin, worst_case_logits

    ramp_steps = max(int(config.ibp_ramp_steps), 0)
    use_crown = config.ibp_bound == "crown"
    if config.ibp_bound not in ("ibp", "crown"):
        raise ValueError(f"unknown ibp_bound '{config.ibp_bound}'")

    def grads_fn(state: TrainState, x01, y, generator):
        f32 = LOSS_DTYPE
        step = torch.tensor(float(state.step), dtype=f32)
        ramp = (torch.clamp(step / ramp_steps, 0.0, 1.0) if ramp_steps > 0
                else torch.tensor(1.0, dtype=f32))
        eps_t = torch.tensor(config.eps, dtype=f32) * ramp
        kappa_t = 1.0 - (1.0 - torch.tensor(config.ibp_kappa, dtype=f32)) * ramp
        dev = x01.device

        def total_loss(params):
            layers = ibp_layers(params, spec)
            clean = spec_forward(layers, spec, normalize_batch(x01.to(f32), mean, std))
            if use_crown:
                def bounds(*leaves):
                    return margin_spec_bounds(ibp_layers(dict(zip(params, leaves)), spec),
                                              spec, x01, y, eps_t.to(dev), mean, std)

                crown, ibp = (checkpoint(bounds, *params.values(), use_reentrant=False)
                              if config.remat else bounds(*params.values()))
                beta_t = (1.0 - (1.0 - torch.tensor(config.ibp_final_beta, dtype=f32))
                          * ramp).to(dev)
                mixed = beta_t * crown + (1.0 - beta_t) * ibp
                robust_logits = -mixed
                mask = F.one_hot(y.long(), mixed.shape[-1]).bool()
                margin = torch.min(torch.where(mask, torch.full_like(mixed, torch.inf), mixed),
                                   dim=-1).values
            else:
                def bounds(*leaves):
                    return logit_bounds(ibp_layers(dict(zip(params, leaves)), spec), spec,
                                        x01, eps_t.to(dev), mean, std)

                lo, hi = (checkpoint(bounds, *params.values(), use_reentrant=False)
                          if config.remat else bounds(*params.values()))
                robust_logits = worst_case_logits(lo, hi, y)
                margin = verified_margin(lo, hi, y)
            k = kappa_t.to(dev)
            loss = (k * _ce_loss(clean, y, config.label_smoothing)
                    + (1.0 - k) * _ce_loss(robust_logits, y, config.label_smoothing))
            return loss, (clean, margin)

        loss, (clean, margin), grads = _param_grads(total_loss, state.params)
        return grads, {"loss": loss,
                       "adv_accuracy": _mean_rows((margin > 0.0).to(f32)),
                       "clean_accuracy": _accuracy(clean, y),
                       "ibp_eps": eps_t.to(dev), "ibp_kappa": kappa_t.to(dev)}

    return _step_with(grads_fn, config)


def save_train_checkpoint(state: TrainState, path, epoch: int) -> None:
    """The whole state (parameters, buffers, AdamW's moments and count, the
    step, the EMA) and ``epoch`` as a torch file, written to ``<path>.tmp``
    and then moved over ``path``, so that a crash never leaves a torn file.
    The layout is the port's own (torch tensors, state-dict names), not the
    JAX package's msgpack."""
    cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
    payload = {"params": cpu(state.params), "extra_variables": cpu(state.extra_variables),
               "opt_state": {"count": int(state.opt_state.count),
                             "mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu)},
               "step": int(state.step), "epoch": int(epoch)}
    if state.ema_params is not None:
        payload["ema_params"] = cpu(state.ema_params)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _restore(template: dict[str, torch.Tensor], saved: dict, what: str) -> dict:
    if set(saved) != set(template):
        raise ValueError(f"checkpoint {what} do not match the model: "
                         f"{sorted(set(saved) ^ set(template))[:5]}")
    out = {}
    for k, t in template.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {k}: shape {tuple(saved[k].shape)}, "
                             f"the model's {tuple(t.shape)}")
        out[k] = saved[k].to(device=t.device, dtype=t.dtype)
    return out


def load_train_checkpoint(state: TrainState, path) -> tuple[TrainState, int]:
    """Restore a ``save_train_checkpoint`` file into ``state`` (a fresh
    state of the same model: its module, optimizer and devices are kept).
    Returns ``(state, the next epoch to run)``.  A state with an EMA refuses
    a file without one."""
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    if state.ema_params is not None and "ema_params" not in payload:
        raise ValueError(f"{path} holds no EMA parameters but the run keeps an EMA "
                         "(--ema_decay): refusing to reset the shadow")
    opt = payload["opt_state"]
    restored = state.replace(
        params=_restore(state.params, payload["params"], "parameters"),
        extra_variables=_restore(state.extra_variables, payload["extra_variables"], "buffers"),
        opt_state=AdamState(int(opt["count"]), _restore(state.opt_state.mu, opt["mu"], "mu"),
                            _restore(state.opt_state.nu, opt["nu"], "nu")),
        step=int(payload["step"]))
    if state.ema_params is not None:
        restored.ema_params = _restore(state.ema_params, payload["ema_params"], "EMA")
    return restored, int(payload["epoch"]) + 1


def deploy_params(state: TrainState) -> dict[str, torch.Tensor]:
    """The parameters to ship: the EMA when kept, else the trained ones."""
    return state.params if state.ema_params is None else state.ema_params


def calibrate_batch_stats(state: TrainState, x01: torch.Tensor, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD, batch_size: int = 256,
                          min_batches: int = 30) -> dict[str, torch.Tensor]:
    """Precise-BN after ``train_bn`` training: ``max(min_batches, n_full)``
    forwards over ``x01`` ([N,H,W,C] in [0,1]; batches repeat when the data
    is short) with the deployed parameters, each moving every BatchNorm's
    running statistics by Flax's rule, ``0.9 * running + 0.1 * batch`` with
    the biased batch variance.  Returns the updated ``extra_variables``
    (unchanged without ``train_bn``)."""
    if not state.train_bn:
        return state.extra_variables
    params = deploy_params(state)
    n = int(x01.shape[0])
    batch_size = max(1, min(int(batch_size), n))
    device = next(iter(state.params.values())).device
    seen: dict[str, tuple] = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.__setitem__(name, batch_moments(inp[0])))
        for name, m in state.model.named_modules()
        if isinstance(m, TrainableBatchNorm2d) and m.train_bn]
    extra = dict(state.extra_variables)
    n_full = max(1, n // batch_size)
    try:
        with torch.no_grad():
            for i in range(max(int(min_batches), n_full)):
                start = (i % n_full) * batch_size
                xb = torch.as_tensor(x01[start:start + batch_size]).to(device)
                seen.clear()
                _apply_model(state.replace(extra_variables=extra), params,
                             normalize_batch(xb, mean, std))
                for name, (m, v) in seen.items():
                    for key, stat in ((f"{name}.running_mean", m), (f"{name}.running_var", v)):
                        extra[key] = (0.9 * extra[key] + 0.1 * stat).to(extra[key].dtype)
    finally:
        for h in hooks:
            h.remove()
    return extra


def make_robust_eval_step(attack_steps: int, eps: float, alpha: float, mean=IMAGENET_MEAN,
                          std=IMAGENET_STD, use_ema: bool = False):
    """``(state, x01, y, generator) -> {robust_accuracy}``: PGD-
    ``attack_steps`` accuracy of the current (or EMA) parameters."""

    def step(state: TrainState, x01, y, generator):
        params = _cast(state, deploy_params(state) if use_ema else state.params)

        def logits_fn(xx):
            return _apply_model(state, params, normalize_batch(xx, mean, std)).to(LOSS_DTYPE)

        x_adv = pgd.pgd_linf_attack(logits_fn, x01, y, eps=eps, alpha=alpha,
                                    steps=int(attack_steps), generator=generator)
        with torch.no_grad():
            return {"robust_accuracy": _accuracy(logits_fn(x_adv), y)}

    return step


def make_eval_step(mean=IMAGENET_MEAN, std=IMAGENET_STD, use_ema: bool = False):
    """``(state, x01, y) -> {clean_accuracy}``; with ``use_ema`` on the EMA
    (the trained parameters where none is kept)."""

    def step(state: TrainState, x01, y):
        params = deploy_params(state) if use_ema else state.params
        with torch.no_grad():
            logits = _apply_model(state, params, normalize_batch(x01, mean, std))
        return {"clean_accuracy": _accuracy(logits.to(LOSS_DTYPE), y)}

    return step

