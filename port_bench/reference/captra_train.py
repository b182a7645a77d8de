"""Plain PyTorch reference of CAPTRA's CoordNet training step (the
"canon_coord" model of config_coordnet.yml), independent of the program:
it imports nothing of the port.

A step on a batch (camera clouds, their GT labels, NPCS, part poses and
NPCS boxes, a perturbed init pose) and the sampled point pairs of the
symmetric NPCS loss:

  1. canonicalize the cloud by the init root pose and run CoordNet in
     training mode (BatchNorm on the batch's moments);
  2. losses: soft mIoU of the segmentation; for a symmetric category the
     distance of y and of the radius in xz to the GT NPCS and the mean
     difference of the pairwise-distance matrices of the sampled points,
     else the L2 NPCS distance; scale and translation fitted to the
     predicted NPCS under the GT rotation (a y-axis 2D refinement for a
     symmetric part, the translation fitted with the GT scale; no gradient
     through the fit's centres or its 2D rotation), their L1 losses to the
     GT, the rotation's Frobenius loss, and the L1 distance of the NPCS box
     corners posed by the GT and by the fit (only the y extent for a
     symmetric part); the total weighted by the configuration;
  3. the gradient, then optax's chain: NaNs to 0, each entry clipped to
     +-1e4, the global norm clipped to grad_clip, weight decay added, Adam
     (0.9, 0.999, 1e-8) at the step-schedule's learning rate.
"""
from __future__ import annotations

import torch

from port_bench.reference.captra import Precision, coordnet

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
ELEMENT_CLIP = 1e4
EPS = 1e-6


def _norm(x, dim=-1):
    return torch.sqrt((x * x).sum(dim) + 1e-24)


def _masked_center(x, m, detach=False):
    wm = m[..., None]
    c = (x * wm).sum(-2, keepdim=True) / torch.clamp(wm.sum(-2, keepdim=True),
                                                     min=1.0)
    if detach:
        c = c.detach()
    return (x - c) * wm


def _fit(pr, npcs, cam, mask, R, sym, init_scale, init_t, gt_scale):
    """Scale and translation under the GT rotation R [B, P, 3, 3]; npcs
    [B, P, N, 3], cam [B, 1, N, 3], mask [B, P, N]."""
    valid = (mask.sum(-1) > 0).float()
    if sym:
        canon = pr.mm(cam, R)                     # rows R^T c, [B, P, N, 3]
        s2 = _masked_center(npcs[..., 0::2], mask)
        t2 = _masked_center(canon[..., 0::2], mask)
        M = pr.mm(t2.transpose(-1, -2), s2).detach()
        c_raw = M[..., 0, 0] + M[..., 1, 1]
        s_raw = M[..., 1, 0] - M[..., 0, 1]
        r = torch.sqrt(c_raw ** 2 + s_raw ** 2)
        ok = (r > 1e-12) & torch.isfinite(r)
        c = torch.where(ok, c_raw / torch.clamp(r, min=1e-12), 1.0)
        s = torch.where(ok, s_raw / torch.clamp(r, min=1e-12), 0.0)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        ry = torch.stack([c, zero, -s, zero, one, zero, s, zero, c],
                         -1).reshape(c.shape + (3, 3))
        rotated = pr.mm(npcs, pr.mm(R, ry).transpose(-1, -2))
    else:
        rotated = pr.mm(npcs, R.transpose(-1, -2))
    camx = cam.expand(rotated.shape)
    rn_c = _masked_center(rotated, mask, detach=True)
    cam_c = _masked_center(camx, mask, detach=True)
    scale = ((rn_c * cam_c * mask[..., None]).sum((-1, -2))
             / ((rn_c * rn_c * mask[..., None]).sum((-1, -2)) + EPS))
    scale = valid * scale + (1.0 - valid) * init_scale
    scale = torch.where(torch.isfinite(scale), scale, init_scale)
    scaled = gt_scale[..., None, None] * rotated
    wn = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    t = ((camx - scaled) * wn[..., None]).sum(-2)[..., None]
    v3 = valid[..., None, None]
    t = v3 * t + (1.0 - v3) * init_t
    ok = torch.isfinite(t.sum((-1, -2), keepdim=True))
    return scale, torch.where(ok, t, init_t)


def _posed(R, t, s, pts):
    return s[..., None, None] * (pts @ R.transpose(-1, -2)) \
        + t.transpose(-1, -2)


def loss(pr, w: dict, cfg: dict, batch: dict, pwm_idx) -> torch.Tensor:
    """The weighted total loss of one batch (see the module)."""
    obj, train = cfg["obj"], cfg["train"]
    P, sym = obj["num_parts"], obj["sym"]
    root = list(obj["tree"]).index(-1)
    weights = train["loss_weight"]
    pts = batch["points"]
    B, N, _ = pts.shape
    mean = pts.mean(1)
    cam = (pts - mean[:, None]) + mean[:, None]
    Ri, ti, si = (batch["init_rotation"], batch["init_translation"],
                  batch["init_scale"])
    canon = (pr.mm(Ri[:, root].transpose(-1, -2),
                   cam.transpose(-1, -2) - ti[:, root])
             / si[:, root, None, None]).transpose(-1, -2)
    seg, nocs = coordnet(pr, w, cfg, canon)
    labels = batch["labels"]
    C = seg.shape[-1]
    gt1 = (labels[..., None] == torch.arange(C, device=labels.device)).float()
    inter = (seg * gt1).sum(-2)
    union = (seg + gt1).sum(-2) - inter
    terms = {"seg_loss": 1.0 - (inter / (union + EPS)).mean()}

    per_part = nocs.reshape(B, N, P, 3)
    lab = torch.clamp(labels, 0, P - 1)
    own = torch.gather(per_part, 2,
                       lab[..., None, None].expand(B, N, 1, 3))[..., 0, :]
    own = torch.where((labels < P)[..., None], own, 0.0)
    gt_nocs = batch["nocs"]
    if sym:
        xg, yg, zg = gt_nocs.unbind(-1)
        xp, yp, zp = own.unbind(-1)
        dist = torch.sqrt((yg - yp) ** 2 + torch.abs(
            xg ** 2 + zg ** 2 - xp ** 2 - zp ** 2) + 1e-8)
        fmask = (labels == 0).float()
        terms["nocs_dist_loss"] = (dist * fmask).sum() / torch.clamp(
            fmask.sum(), min=1.0)
        idx = pwm_idx[..., None].expand(-1, -1, 3)
        sg, sp = torch.gather(gt_nocs, 1, idx), torch.gather(own, 1, idx)

        def dmat(p):
            return _norm(p[:, :, None] - p[:, None])
        pwm = (dmat(sg) - dmat(sp)).abs().mean((-1, -2))
        valid = (fmask.sum(-1) > 0).float()
        terms["nocs_pwm_loss"] = (pwm * valid).sum() / torch.clamp(
            valid.sum(), min=1.0)
    else:
        inpart = (labels < P).float()
        terms["nocs_loss"] = (_norm(own - gt_nocs) * inpart).sum() \
            / torch.clamp(inpart.sum(), min=1.0)

    Rg, tg, sg_ = batch["rotation"], batch["translation"], batch["scale"]
    npcs = nocs.reshape(B, N, P, 3).permute(0, 2, 1, 3)
    mask = (labels[:, None, :] == torch.arange(P, device=labels.device)[
        None, :, None]).float()
    scale, t = _fit(pr, npcs, cam[:, None], mask, Rg, sym, si, ti, sg_)
    terms["sloss"] = (sg_ - scale).abs().mean()
    terms["tloss"] = _norm((tg - t)[..., 0]).mean()
    d = Rg - Rg
    terms["rloss"] = (d * d).sum((-1, -2)).mean()
    box = batch["corners"]
    if sym:
        box = box * torch.tensor((0.0, 1.0, 0.0), device=box.device)
    diff = _posed(Rg, tg, sg_, box) - _posed(Rg, t, scale, box)
    terms["corner_loss"] = _norm(diff).mean()
    total = 0.0
    for k, v in weights.items():
        if k in terms:
            total = total + terms[k] * v
    return total


def lr_at(train: dict, step: int, steps_per_epoch: int) -> float:
    epoch = step // steps_per_epoch
    lr = train["learning_rate"] * train["lr_gamma"] ** (
        epoch // train["lr_step_size"])
    return max(lr, train["lr_clip"])


class Adam:
    """optax's clip / weight decay / Adam chain over a dict of leaves."""

    def __init__(self, params: dict, train: dict, steps_per_epoch: int):
        self.train = train
        self.steps_per_epoch = steps_per_epoch
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def processed(self, grads: dict, params: dict) -> dict:
        """The gradient as the Adam moments take it: NaNs zeroed, entries
        clipped, the global norm clipped, weight decay added."""
        clip = self.train["grad_clip"]
        g = {k: torch.clamp(torch.nan_to_num(v, nan=0.0, posinf=torch.inf,
                                             neginf=-torch.inf),
                            -ELEMENT_CLIP, ELEMENT_CLIP)
             for k, v in grads.items()}
        if clip > 0:
            norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
            if float(norm) >= clip:
                g = {k: v / norm * clip for k, v in g.items()}
        wd = self.train["weight_decay"]
        return {k: v + wd * params[k] for k, v in g.items()}

    @torch.no_grad()
    def step(self, grads: dict, params: dict) -> dict:
        g = self.processed(grads, params)
        lr = lr_at(self.train, self.count, self.steps_per_epoch)
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for k in params:
            self.mu[k] = (1 - B1) * g[k] + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g[k] * g[k] + B2 * self.nu[k]
            params[k] -= lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
        return g


def follow(w: dict, cfg: dict, batches: list, pwm: list, learnable: list,
           steps_per_epoch: int, matmul: str = "float32") -> dict:
    """The reference's first len(batches) steps from the weights `w` (its
    own copy): each step's loss, the first step's processed gradient by
    leaf and the parameters after the last step by leaf."""
    pr = Precision(matmul, train=True)
    w = {k: v.detach().clone() for k, v in w.items()}
    params = {k: w[k] for k in learnable}
    opt = Adam(params, cfg["train"], steps_per_epoch)
    losses, first = [], None
    for batch, idx in zip(batches, pwm):
        for k in learnable:
            params[k].requires_grad_(True)
        total = loss(pr, w, cfg, batch, idx)
        grads = torch.autograd.grad(total, [params[k] for k in learnable])
        for k in learnable:
            params[k].requires_grad_(False)
        g = opt.step(dict(zip(learnable, grads)), params)
        if first is None:
            first = g
        losses.append(float(total.detach()))
    return {"losses": losses, "grad": first,
            "params": {k: v.clone() for k, v in params.items()}}
