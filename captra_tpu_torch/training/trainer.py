"""Training: schedules, the optimizer chain, the loss stacks and the train
and eval steps (counterpart of `captra_tpu/training/trainer.py`).

The JAX trainer is one jitted `value_and_grad` step over an optax chain.
Here a step is an eager forward in train mode, `backward()` and the same
chain written by hand:

  * the parameters of the net are views into one flat float32 buffer and
    their gradients views into another (`TrainState.params` / `.grads`),
    so the chain runs as a few elementwise kernels over the whole net;
  * the chain is optax's, term for term (optax 0.2.6): `zero_nans` (NaN to
    0, +-inf kept), `clip(1e4)` per entry, `clip_by_global_norm(grad_clip)`
    (g / |g| * max_norm only when |g| >= max_norm, no epsilon), then
    `add_decayed_weights`, then Adam (mu, nu, bias-corrected with the
    incremented count, mu_hat / (sqrt(nu_hat) + 1e-8)) or SGD's
    `trace(0.9)`, scaled by the negative learning rate of the count before
    the update.  torch's own pieces differ (`clip_grad_norm_` adds 1e-6,
    `nan_to_num` rewrites inf, `torch.optim.Adam` folds the bias
    correction differently);
  * the step count lives on the host, so the learning rate and the bias
    corrections are host scalars: a step synchronises the host only where
    its batch is copied in from pageable memory;
  * BatchNorm writes its running statistics itself in train mode, in
    flax's formula, keeping the old value of any non-finite entry
    (`models/blocks.py`); the epoch schedule only sets each BN's momentum.

Every random draw is explicit: the pose noise of `add_noise_to_pose` and
the symmetric NOCS loss's sample come from `draws` (what
`captra_tpu_torch.pose.part_dof.draw_pose_noise` and
`models.losses.draw_pwm_indices` give) or from a `torch.Generator`.
`train_step` updates the state in place and returns it; its losses and
metrics stay on the device.  It opens the tracer's spans
(`utils/profiling.annotate`, recorded only while a profiler runs):
`train.step` around it, `train.forward` (forward and losses),
`train.backward` and `train.optimizer` inside it.

Data parallelism (`Trainer(..., dp=)`, a `parallel.mesh.DataParallel`):
each rank steps on its shard of the global batch.  Its forward runs under
`mesh.active(dp)`, so BatchNorm normalises with the global statistics and
each loss is the rank's share of the global batch's; after `backward` one
all-reduce adds the ranks' flat gradients, and the optimizer (the same on
every rank) sees the global gradient, as the JAX step over a mesh does.
Draws taken from a generator are drawn over the global batch from the
same generator on every rank, which then takes its rows; draws given
(`draws=`) are this rank's rows.  The returned losses and metrics are
the global batch's (one all-reduce of their values).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch import nn

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.models import losses as L
from captra_tpu_torch.models.blocks import set_bn_momentum
from captra_tpu_torch.models.coordnet import CoordNet, canonicalize, solve_st
from captra_tpu_torch.models.rotnet import (
    RotNet, canonicalize_per_part, decode_rotation,
)
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.pose import bbox as bbox_utils
from captra_tpu_torch.pose.part_dof import (
    Pose, add_noise_to_pose, compute_parts_delta_pose, draw_pose_noise,
    eval_part_full, merge_delta_pose, tree_root,
)
from captra_tpu_torch.pose.pose_fit import labels_to_part_mask
from captra_tpu_torch.utils.profiling import annotate

# Adam's constants (optax.scale_by_adam defaults) and SGD's trace decay
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
SGD_DECAY = 0.9
ELEMENT_CLIP = 1e4
# parameter offsets in the flat buffers are multiples of this many floats
_ALIGN = 64


# ---------------------------------------------------------------------------
# schedules & optimizer
# ---------------------------------------------------------------------------

def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable:
    """StepLR: x lr_gamma every lr_step_size epochs, clipped below at
    lr_clip; step -> learning rate, in float32 as the JAX schedule
    computes it."""
    o = cfg.optim

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        lr = np.float32(o.learning_rate) * (
            np.float32(o.lr_gamma) ** np.float32(epoch // o.lr_step_size))
        return float(np.maximum(lr, np.float32(o.lr_clip)))

    return schedule


def bn_momentum_for_epoch(cfg: Config, epoch: int) -> float:
    """Flax-convention BN momentum for an epoch (1 - the reference's torch
    momentum, decayed every bn_momentum_step_size epochs, floored)."""
    o = cfg.optim
    m_torch = max(
        o.bn_momentum_original * (
            o.bn_momentum_decay ** (epoch // o.bn_momentum_step_size)),
        o.bn_momentum_min)
    return 1.0 - m_torch


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay ** count in float32, as optax computes it
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The JAX package's `make_optimizer` chain over flat buffers.

    `init(params)` gives the state {"count": 0, "mu", "nu"} (Adam) or
    {"count": 0, "trace"} (SGD), moments shaped like `params`;
    `step(state, params, grads)` applies one update to `params` in place
    and returns the new state; `grads` is left as it was."""

    def __init__(self, cfg: Config, steps_per_epoch: int):
        o = cfg.optim
        if o.optimizer not in ("adam", "sgd"):
            raise ValueError(f"unsupported optimizer {o.optimizer}")
        self.kind = o.optimizer
        self.grad_clip = o.grad_clip
        self.weight_decay = o.weight_decay
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)

    def init(self, params: torch.Tensor) -> dict:
        if self.kind == "adam":
            return {"count": 0, "mu": torch.zeros_like(params),
                    "nu": torch.zeros_like(params)}
        return {"count": 0, "trace": torch.zeros_like(params)}

    def step(self, state: dict, params: torch.Tensor,
             grads: torch.Tensor) -> dict:
        g = grads
        if self.grad_clip > 0:
            g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
            g = torch.clamp(g, -ELEMENT_CLIP, ELEMENT_CLIP)
            norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(norm < self.grad_clip, g,
                            (g / norm) * self.grad_clip)
        g = g + self.weight_decay * params
        count = state["count"]
        lr = self.schedule(count)
        if self.kind == "adam":
            mu = (1 - B1) * g + B1 * state["mu"]
            nu = (1 - B2) * (g * g) + B2 * state["nu"]
            inc = count + 1
            u = (mu / _bias_correction(B1, inc)) / (
                torch.sqrt(nu / _bias_correction(B2, inc)) + ADAM_EPS)
            new = {"count": inc, "mu": mu, "nu": nu}
        else:
            u = g + SGD_DECAY * state["trace"]
            new = {"count": count + 1, "trace": u}
        params.copy_(params + (-lr) * u)
        return new


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The net (its parameters and BN statistics), the flat parameter and
    gradient buffers its parameters and gradients are views of, the
    optimizer state and the step.  `layout`: (parameter name, offset,
    shape) in `module.named_parameters()` order."""
    module: nn.Module
    params: torch.Tensor
    grads: torch.Tensor
    opt_state: dict
    step: int = 0
    layout: list = field(default_factory=list)

    def param_views(self, flat: torch.Tensor) -> dict:
        """{parameter name: the view of `flat` (a buffer of the params'
        layout) that holds it}."""
        return {name: flat[o:o + int(np.prod(shape))].view(shape)
                for name, o, shape in self.layout}


def flatten_parameters(module: nn.Module):
    """Move the parameters of `module` into one flat buffer (float32, or
    the parameters' own dtype) and their gradients into another (zeroed),
    each parameter and gradient a view: returns (params, grads,
    layout)."""
    named = list(module.named_parameters())
    layout, offset = [], 0
    for name, p in named:
        layout.append((name, offset, tuple(p.shape)))
        offset += -(-p.numel() // _ALIGN) * _ALIGN
    first = named[0][1]
    params = torch.zeros(offset, dtype=first.dtype, device=first.device)
    grads = torch.zeros_like(params)
    with torch.no_grad():
        for (name, p), (_, o, shape) in zip(named, layout):
            n = p.numel()
            params[o:o + n].copy_(p.detach().reshape(-1))
            p.data = params[o:o + n].view(shape)
            p.grad = grads[o:o + n].view(shape)
    return params, grads, layout


def to_device(batch: dict, device: torch.device) -> dict:
    """A batch (tensors, numpy arrays, `Pose`s) on `device`; a CPU tensor
    bound for the card goes through pinned memory, without a host
    synchronisation."""
    def move(x):
        if isinstance(x, Pose):
            return x.map(move)
        x = torch.as_tensor(x)
        if x.device == device:
            return x
        if device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    return {k: move(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# loss functions (train and eval)
# ---------------------------------------------------------------------------

def _apply_crop_pose(init_part: Pose, batch: dict) -> Pose:
    """The init pose with its t / s replaced by the perturbed crop pose
    where the data pipeline gives one (reference prepare_poses,
    model.py:49-58)."""
    if "crop_translation" not in batch:
        return init_part
    t = batch["crop_translation"].expand(init_part.translation.shape)
    s = batch["crop_scale"].expand(init_part.scale.shape)
    return Pose(rotation=init_part.rotation, translation=t, scale=s)


def _gt_bbox(corners: torch.Tensor, sym: bool) -> torch.Tensor:
    """Corner-loss points from NPCS corners."""
    if sym:
        return bbox_utils.yaxis_from_corners(corners)
    return bbox_utils.bbox_from_corners(corners)


def _init_pose(cfg: Config, batch: dict, draws: dict,
               generator: torch.Generator | None) -> Pose:
    """The perturbed GT (the training init pose), or the batch's own
    `init_pose`."""
    if "init_pose" in batch:
        return batch["init_pose"]
    p = cfg.perturb
    noise, dp = draws.get("noise"), mesh.current()
    if noise is None and dp is not None and generator is not None:
        # the global batch's draws, this rank's rows
        shape = batch["pose"].scale.shape
        noise = mesh.shard_batch(draw_pose_noise(
            (shape[0] * dp.world, *shape[1:]), p.kind, generator), dp.rank,
            dp.world)
    init_part = add_noise_to_pose(
        batch["pose"], rot_rad=float(np.deg2rad(p.r)), trans_sigma=p.t,
        scale_sigma=p.s, kind=p.kind, noise=noise, generator=generator)
    return _apply_crop_pose(init_part, batch)


def _metrics(gt: Pose, pred: Pose, sym: bool) -> dict:
    with torch.no_grad():
        pred = pred.map(torch.Tensor.detach)
        return {k: L.batch_mean(v) for k, v in
                eval_part_full(gt, pred, yaxis_only=sym).items()}


def coordnet_loss(cfg: Config, module: CoordNet, batch: dict,
                  draws: dict | None = None,
                  generator: torch.Generator | None = None,
                  use_pred_labels: bool = False):
    """CanonCoordModel loss stack.  batch: points [B, N, 3] raw camera
    cloud; labels [B, N]; nocs [B, N, 3]; pose: GT `Pose` [B, P]; corners
    [B, P, 2, 3].  The module's mode (train / eval) is the caller's.
    Returns (total, (loss dict, metrics))."""
    draws = draws or {}
    obj = cfg.obj
    root = tree_root(obj.tree)
    gt: Pose = batch["pose"]
    init_part = _init_pose(cfg, batch, draws, generator)
    canon_pose = init_part[:, root]

    points_raw = batch["points"]
    points_mean = torch.mean(points_raw, dim=1)
    points = points_raw - points_mean[:, None]
    canon_pts = canonicalize(points, points_mean, canon_pose)

    out = module(canon_pts)
    seg, nocs = out["seg"], out["nocs"]
    gt_labels = batch["labels"]
    labels = torch.argmax(seg, dim=-1) if use_pred_labels else gt_labels

    loss_dict = {"seg_loss": L.miou_loss(seg, gt_labels)}
    if obj.sym:
        dist_l, pwm_l = L.sym_nocs_loss(
            nocs, batch["nocs"], labels, obj.num_parts,
            pwm_num=cfg.network.pwm_num, pwm_idx=draws.get("pwm_idx"),
            generator=generator)
        loss_dict["nocs_dist_loss"] = dist_l
        loss_dict["nocs_pwm_loss"] = pwm_l
    else:
        loss_dict["nocs_loss"] = L.nocs_loss(nocs, batch["nocs"], labels,
                                             obj.num_parts)

    # the s / t solve with the GT rotation; GT scale feeds the translation
    # fit at train time
    pred_part = solve_st(
        seg, nocs, points, points_mean, labels, gt.rotation, init_part,
        num_parts=obj.num_parts, sym=obj.sym,
        given_scale=None if use_pred_labels else gt.scale)

    loss_dict.update(L.part_dof_loss(gt, pred_part, cfg.pose_loss_type))
    gt_box = _gt_bbox(batch["corners"], obj.sym)
    loss_dict["corner_loss"], _ = L.point_pose_loss(
        gt, pred_part, gt_box, metric=cfg.pose_loss_type["point"])
    total = L.weighted_total(loss_dict, cfg.loss_weight)
    return total, (loss_dict, _metrics(gt, pred_part, obj.sym))


def rotnet_loss(cfg: Config, module: RotNet, batch: dict,
                draws: dict | None = None,
                generator: torch.Generator | None = None):
    """RotationModel loss stack (batch as `coordnet_loss`'s)."""
    draws = draws or {}
    obj = cfg.obj
    gt: Pose = batch["pose"]
    init_part = _init_pose(cfg, batch, draws, generator)
    # the canonicalization pose of each part is the init pose itself: the
    # supervision is the canonical-frame delta
    root_delta = compute_parts_delta_pose(init_part, gt, init_part)

    points_raw = batch["points"]
    points_mean = torch.mean(points_raw, dim=1)
    points = points_raw - points_mean[:, None]
    labels = batch["labels"]

    canon_parts = canonicalize_per_part(points, points_mean, init_part)
    out = module(canon_parts, labels)

    delta, point_rot = decode_rotation(out, obj.sym)
    # mode 'rot': the composed rotation with GT s / t
    merged = merge_delta_pose(init_part, delta_rotation=delta)
    pred_part = Pose(rotation=merged.rotation, translation=gt.translation,
                     scale=gt.scale)

    loss_dict = L.part_dof_loss(gt, pred_part, cfg.pose_loss_type)
    # per-point rotation loss against the delta target, in-part points only
    gt_rot = root_delta.rotation[:, :, None]  # [B, P, 1, 3, 3]
    if obj.sym:
        rl = L.rot_yaxis_loss(gt_rot, point_rot)
    else:
        rl = L.rot_trace_loss(gt_rot, point_rot,
                              metric=cfg.pose_loss_type["r"])
    mask = labels_to_part_mask(labels, obj.num_parts)
    loss_dict["rloss"] = L.masked_ratio(torch.sum(rl * mask), torch.sum(mask))
    gt_box = _gt_bbox(batch["corners"], obj.sym)
    loss_dict["corner_loss"], _ = L.point_pose_loss(
        gt, pred_part, gt_box, metric=cfg.pose_loss_type["point"])
    total = L.weighted_total(loss_dict, cfg.loss_weight)
    return total, (loss_dict, _metrics(gt, pred_part, obj.sym))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Builds the net, the optimizer and the steps for `network.type`:
    canon_coord -> CoordNet, rot -> RotNet; on `device` (CUDA unless
    given; raises without a card).  With `dp` (a
    `parallel.mesh.DataParallel`) its steps take this rank's shard of a
    global batch and step as the single-device trainer does on the
    global batch."""

    def __init__(self, cfg: Config, steps_per_epoch: int = 100,
                 epoch: int = 0, device=None,
                 dp: mesh.DataParallel | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = dp
        self.steps_per_epoch = steps_per_epoch
        net_type = cfg.network.type
        if net_type == "canon_coord":
            self.net_cls, self.loss_fn = CoordNet, coordnet_loss
        elif net_type == "rot":
            self.net_cls, self.loss_fn = RotNet, rotnet_loss
        else:
            raise ValueError(f"Trainer does not train type {net_type!r}; "
                             "tracking uses captra_tpu_torch.tracking")
        self.tx = Optimizer(cfg, steps_per_epoch)
        self.set_epoch(epoch)

    def set_epoch(self, epoch: int) -> None:
        """Apply the BN-momentum schedule (taken up by the next step)."""
        self.epoch = epoch
        self.bn_momentum = bn_momentum_for_epoch(self.cfg, epoch)

    def init_state(self, generator: torch.Generator | None = None,
                   variables=None) -> TrainState:
        """A fresh state: the net drawn xavier-uniform from `generator` (a
        CPU generator), or holding the flax `variables` ({"params",
        "batch_stats"} numpy trees), and fresh optimizer moments."""
        from captra_tpu_torch.training.convert import load_flax_variables
        module = self.net_cls(self.cfg, bn_momentum=self.bn_momentum,
                              device=self.device, generator=generator)
        if variables is not None:
            load_flax_variables(module, variables)
        params, grads, layout = flatten_parameters(module)
        return TrainState(module=module, params=params, grads=grads,
                          opt_state=self.tx.init(params), step=0,
                          layout=layout)

    def copy_state(self, state: TrainState) -> TrainState:
        """An independent copy of `state` (net, statistics, moments,
        step)."""
        module = copy.deepcopy(state.module)
        params, grads, layout = flatten_parameters(module)
        opt = {k: (v.clone() if torch.is_tensor(v) else v)
               for k, v in state.opt_state.items()}
        return TrainState(module=module, params=params, grads=grads,
                          opt_state=opt, step=state.step, layout=layout)

    def draw(self, batch: dict, generator: torch.Generator) -> dict:
        """The draws of one train step on `batch` from `generator`: the
        pose noise (none when the batch carries its `init_pose`) and, for a
        symmetric CoordNet, the NOCS pairwise sample over the GT labels."""
        return self.draw_for(batch["labels"], "init_pose" in batch,
                             generator)

    def draw_for(self, labels, init_pose: bool,
                 generator: torch.Generator) -> dict:
        """`draw` for a batch of GT labels [B, N] that carries its
        `init_pose` or not."""
        labels = torch.as_tensor(labels)
        draws = {}
        if not init_pose:
            draws["noise"] = draw_pose_noise(
                (labels.shape[0], self.cfg.obj.num_parts),
                self.cfg.perturb.kind, generator)
        if self.cfg.network.type == "canon_coord" and self.cfg.obj.sym:
            draws["pwm_idx"] = L.draw_pwm_indices(
                labels.to(generator.device), self.cfg.network.pwm_num,
                generator)
        return draws

    def train_step(self, state: TrainState, batch: dict,
                   draws: dict | None = None,
                   generator: torch.Generator | None = None):
        """One update of `state` (in place) on `batch`: returns (state, loss
        dict with "total_loss", metrics), 0-d tensors on the device.  The
        draws are `draws`, else drawn from `generator`."""
        with annotate("train.step"):
            module = state.module
            set_bn_momentum(module, self.bn_momentum)
            module.train()
            batch = to_device(batch, self.device)
            state.grads.zero_()
            with mesh.active(self.dp):
                with annotate("train.forward"):
                    total, (loss_dict, metrics) = self.loss_fn(
                        self.cfg, module, batch, draws=draws,
                        generator=generator)
                with annotate("train.backward"):
                    total.backward()
            self._check_grads(state)
            if self.dp is not None:
                self.dp.all_reduce_(state.grads)
            with annotate("train.optimizer"):
                state.opt_state = self.tx.step(state.opt_state, state.params,
                                               state.grads)
            state.step += 1
            loss_dict = {k: v.detach() for k, v in loss_dict.items()}
            loss_dict["total_loss"] = total.detach()
            loss_dict, metrics = self._global(loss_dict, metrics)
            return state, loss_dict, metrics

    def eval_step(self, state: TrainState, batch: dict,
                  draws: dict | None = None,
                  generator: torch.Generator | None = None):
        """The losses and metrics of `batch` in eval mode (running
        statistics; CoordNet selects coordinates and solves s / t with the
        predicted labels): (loss dict with "total_loss", metrics)."""
        module = state.module
        module.eval()
        kw = ({"use_pred_labels": True}
              if self.cfg.network.type == "canon_coord" else {})
        batch = to_device(batch, self.device)
        with torch.no_grad(), mesh.active(self.dp):
            total, (loss_dict, metrics) = self.loss_fn(
                self.cfg, module, batch, draws=draws, generator=generator,
                **kw)
        loss_dict = dict(loss_dict)
        loss_dict["total_loss"] = total
        return self._global(loss_dict, metrics)

    def _global(self, loss_dict: dict, metrics: dict):
        """The global batch's losses and metrics from this rank's shares
        (one all-reduce of their values); as given without `dp`."""
        if self.dp is None:
            return loss_dict, metrics
        merged = [*loss_dict.items(), *metrics.items()]
        values = self.dp.all_reduce_(torch.stack(
            [v.to(torch.float64) for _, v in merged]))
        out = [(k, values[i].to(v.dtype)) for i, (k, v) in enumerate(merged)]
        return dict(out[:len(loss_dict)]), dict(out[len(loss_dict):])

    @staticmethod
    def _check_grads(state: TrainState) -> None:
        # autograd accumulates into an existing .grad in place; a gradient
        # that was replaced instead would leave the flat buffer stale
        for (name, p), (_, o, _) in zip(state.module.named_parameters(),
                                        state.layout):
            if p.grad is None or p.grad.data_ptr() != (
                    state.grads.data_ptr() + o * state.grads.element_size()):
                raise RuntimeError(f"the gradient of {name} left the flat "
                                   "gradient buffer")
