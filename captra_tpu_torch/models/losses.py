"""Training losses (counterpart of `captra_tpu/models/losses.py`).

Pure functions of fixed-shape tensors.  The symmetric NOCS pairwise term's
random point sample is explicit: `sym_nocs_loss` takes the sampled indices
[B, M], or draws them from a `torch.Generator` (`draw_pwm_indices`), where
the JAX function draws them with `jax.random.categorical`.

Under an active data-parallel group (`parallel.mesh.active`) each rank's
loss is its share of the global batch's: a mean over the batch is the
rank's sum over the global count (`batch_mean`), a masked ratio the rank's
sum over the global mask count (`masked_ratio`, the count all-reduced
outside autograd: it only divides) and a constant term the constant over
the ranks (`share`).  So the ranks' losses add up to the single-device
loss on the global batch, and so do their gradients.
"""
from __future__ import annotations

import torch

from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.pose.part_dof import Pose, apply_pose
from captra_tpu_torch.pose.rotations import matrix_to_rotvec
from captra_tpu_torch.utils.precision import f32_precision

EPS = 1e-6


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every entry of `x` (leading axis the batch), or under a
    data-parallel group this rank's share of the global mean: its sum over
    the global count (equal shards)."""
    dp = mesh.current()
    if dp is None:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * dp.world)


def masked_ratio(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """num / max(count, 1) for a masked sum and its mask count, or under a
    data-parallel group this rank's num over the global count (summed over
    the ranks outside autograd)."""
    dp = mesh.current()
    if dp is not None:
        count = dp.all_reduce_(count.detach().clone())
    return num / torch.clamp(count, min=1.0)


def share(value: float) -> float:
    """A constant term of a loss: `value`, or its share on each rank of a
    data-parallel group."""
    dp = mesh.current()
    return value if dp is None else value / dp.world


def safe_norm(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """L2 norm with a zero subgradient at 0: sqrt(sum(x^2) + 1e-24)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-24)


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------

def _one_hot(labels: torch.Tensor, C: int) -> torch.Tensor:
    """Float one-hot [..., C]; labels outside [0, C) give zeros (as
    `jax.nn.one_hot`), and no host synchronisation (`F.one_hot` checks the
    range)."""
    classes = torch.arange(C, device=labels.device)
    return (labels[..., None] == classes).float()


def miou_loss(pred: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Soft mIoU: pred [B, N, C] (softmax probs), labels [B, N]."""
    gt = _one_hot(labels, pred.shape[-1])
    inter = torch.sum(pred * gt, dim=-2)           # [B, C]
    union = torch.sum(pred + gt, dim=-2) - inter
    miou = inter / (union + EPS)
    return share(1.0) - batch_mean(miou)


# ---------------------------------------------------------------------------
# NOCS regression
# ---------------------------------------------------------------------------

def choose_coord_by_label(nocs: torch.Tensor, labels: torch.Tensor,
                          num_parts: int) -> torch.Tensor:
    """Each point's own-part coordinates: nocs [B, N, 3P], labels [B, N] ->
    [B, N, 3]; labels >= P give zeros."""
    B, N, _ = nocs.shape
    per_part = nocs.reshape(B, N, num_parts, 3)
    lab = torch.clamp(labels, 0, num_parts - 1).long()
    picked = torch.gather(per_part, 2,
                          lab[..., None, None].expand(B, N, 1, 3))[..., 0, :]
    return torch.where((labels < num_parts)[..., None], picked,
                       torch.zeros_like(picked))


def nocs_loss(nocs_pred: torch.Tensor, nocs_gt: torch.Tensor,
              labels: torch.Tensor, num_parts: int) -> torch.Tensor:
    """Per-point L2 over in-part points: nocs_pred [B, N, 3P], nocs_gt
    [B, N, 3]."""
    pred = choose_coord_by_label(nocs_pred, labels, num_parts)
    raw = safe_norm(pred - nocs_gt, dim=-1)  # [B, N]
    mask = (labels < num_parts).float()
    return masked_ratio(torch.sum(raw * mask), torch.sum(mask))


def draw_pwm_indices(labels: torch.Tensor, pwm_num: int,
                     generator: torch.Generator,
                     rows: tuple[int, int] | None = None) -> torch.Tensor:
    """`pwm_num` indices a row [B, M] (int64), uniform over the row's points
    with label 0, or over all its points when it has none (the JAX
    function's categorical over logits 0 / -1e9), drawn by inverse CDF from
    `generator` (on the labels' device).  rows=(first, total): `labels`
    are rows first.. of a batch of `total` rows, and the uniforms are drawn
    for all of them (the draws of that batch, these rows taken)."""
    w = (labels == 0).float()
    w = torch.where(w.sum(dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    cdf = torch.cumsum(w, dim=-1)
    B = labels.shape[0]
    first, total = rows or (0, B)
    u = torch.rand((total, pwm_num), generator=generator,
                   device=labels.device)[first:first + B] * cdf[:, -1:]
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, max=labels.shape[1] - 1)


def sym_nocs_loss(nocs_pred: torch.Tensor, nocs_gt: torch.Tensor,
                  labels: torch.Tensor, num_parts: int, pwm_num: int = 128,
                  pwm_idx: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """Symmetric-category NOCS loss: the y + radial distance term and the
    pairwise-distance-matrix term over `pwm_num` sampled part-0 points.
    Returns (dist_loss, pwm_loss).

    The sample is explicit: pwm_idx [B, M], else drawn from `generator`
    (`draw_pwm_indices`; under a data-parallel group, the global batch's
    draw, this rank's rows), else this raises."""
    pred = choose_coord_by_label(nocs_pred, labels, num_parts)
    x_gt, y_gt, z_gt = nocs_gt.unbind(-1)
    x_p, y_p, z_p = pred.unbind(-1)
    dist = torch.sqrt((y_gt - y_p) ** 2 + torch.abs(
        x_gt ** 2 + z_gt ** 2 - x_p ** 2 - z_p ** 2) + 1e-8)
    fmask = (labels == 0).float()
    valid = (torch.sum(fmask, dim=-1) > 0).float()  # [B]
    dist_loss = masked_ratio(torch.sum(dist * fmask), torch.sum(fmask))

    if pwm_idx is None:
        if generator is None:
            raise ValueError("sym_nocs_loss needs its sample (pwm_idx=) or "
                             "a torch.Generator")
        dp, B = mesh.current(), labels.shape[0]
        pwm_idx = draw_pwm_indices(
            labels, pwm_num, generator,
            rows=None if dp is None else (dp.rank * B, B * dp.world))
    idx = pwm_idx.long()[..., None].expand(-1, -1, 3)

    def dist_mat(p):
        return safe_norm(p[:, :, None] - p[:, None], dim=-1)

    s_gt = torch.gather(nocs_gt, 1, idx)
    s_pred = torch.gather(pred, 1, idx)
    pwm = torch.mean(torch.abs(dist_mat(s_gt) - dist_mat(s_pred)),
                     dim=(-1, -2))
    pwm_loss = masked_ratio(torch.sum(pwm * valid), torch.sum(valid))
    return dist_loss, pwm_loss


# ---------------------------------------------------------------------------
# pose losses
# ---------------------------------------------------------------------------

@f32_precision
def rot_trace_loss(rot1: torch.Tensor, rot2: torch.Tensor,
                   metric: str = "frob") -> torch.Tensor:
    """Rotation losses on [B, ..., 3, 3]: exp_l2 / exp_l1 (rotation-vector
    difference), frob, l2 / l1 (trace)."""
    if metric.startswith("exp"):
        diff = matrix_to_rotvec(rot1) - matrix_to_rotvec(rot2)
        return diff ** 2 if metric == "exp_l2" else torch.abs(diff)
    if metric == "frob":
        d = rot1 - rot2
        m = d @ d.transpose(-1, -2)
        return m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    m = rot1 @ rot2.transpose(-1, -2)
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    if metric == "l2":
        return (tr - 3.0) ** 2
    if metric == "l1":
        return torch.abs(tr - 3.0)
    raise ValueError(f"unsupported metric {metric}")


def rot_yaxis_loss(rot1: torch.Tensor, rot2: torch.Tensor,
                   metric: str = "l2") -> torch.Tensor:
    """y-column loss for symmetric categories."""
    diff = rot1[..., 1] - rot2[..., 1]
    if metric == "l2":
        return torch.sum(diff ** 2, dim=-1)
    return safe_norm(diff, dim=-1)


def trans_loss(t1: torch.Tensor, t2: torch.Tensor,
               metric: str = "l1") -> torch.Tensor:
    if metric == "l2":
        return torch.sum((t1 - t2) ** 2, dim=(-1, -2))
    return safe_norm((t1 - t2)[..., 0], dim=-1)


def scale_loss(s1: torch.Tensor, s2: torch.Tensor,
               metric: str = "l1") -> torch.Tensor:
    return (s1 - s2) ** 2 if metric == "l2" else torch.abs(s1 - s2)


@f32_precision
def point_pose_loss(gt_pose: Pose, pred_pose: Pose, pts: torch.Tensor,
                    metric: str = "l1"):
    """Corner loss: distance between box points posed by GT and by the
    prediction, pts [B, P, K, 3]; returns (mean, per-point distances)."""
    diff = apply_pose(gt_pose, pts) - apply_pose(pred_pose, pts)
    if metric == "l2":
        dist = torch.sum(diff ** 2, dim=-1)
    else:
        dist = safe_norm(diff, dim=-1)
    return batch_mean(dist), dist


def part_dof_loss(gt: Pose, pred: Pose, loss_type) -> dict:
    """s / t / r losses, means."""
    return {
        "sloss": batch_mean(scale_loss(gt.scale, pred.scale,
                                       loss_type["s"])),
        "tloss": batch_mean(trans_loss(gt.translation, pred.translation,
                                       loss_type["t"])),
        "rloss": batch_mean(rot_trace_loss(gt.rotation, pred.rotation,
                                           loss_type["r"])),
    }


def weighted_total(loss_dict: dict, weights) -> torch.Tensor:
    """Sum of the weighted losses present in the dict."""
    total = 0.0
    for k, w in weights.items():
        if k in loss_dict:
            total = total + loss_dict[k] * w
    return total
