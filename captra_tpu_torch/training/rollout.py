"""On-policy rollout fine-tuning (counterpart of
`captra_tpu/training/rollout.py`).

The trackers train RotationNet on GT poses perturbed by fresh noise, while
tracking feeds each frame the previous frame's fitted pose, so the nets
never train on their own error distribution.  A round closes that loop,
DAgger-style: synthesize fresh trajectories of pooled geometry on the
device (`data/synthetic.py::device_trajectory_batch`), track them with the
current nets, harvest each tracked frame with the pose the tracker carried
into it as the training state's `init_pose`, and train both nets on those
states with the GT supervision of the standard losses (optionally mixed
with standard noise-perturbation batches).

The JAX round is one jitted program (a `lax.scan` of the tracker, then one
of the train steps); here it is an eager loop of the same steps on the
device.  Every draw is explicit: `round_fn.draw(generator)` makes a
round's draws in a fixed structure, which `round_fn(..., draws=)` takes.
The rollout runs the states' own nets in eval mode without autograd, so
their BatchNorm statistics do not move; each train step puts its net back
in train mode.  A round's logs stay on the device as 0-d tensors, and the
round makes no host synchronisation of its own.
"""
from __future__ import annotations

import torch

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.data.synthetic import (
    device_pose_batch, device_trajectory_batch, draw_pose_batch,
    draw_trajectory_batch,
)
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.pose.part_dof import Pose, draw_pose_noise
from captra_tpu_torch.tracking.tracker import (
    evaluate_track, init_pose_from_gt, make_track_step, track_trajectory,
)


def collect_states(cfg: Config, coord_fn, rot_fn, traj: dict,
                   init_pose: Pose, device=None) -> tuple[dict, dict]:
    """Track `traj` with (coord_fn, rot_fn) and harvest the tracked frames
    as single-frame training states.

    traj: {points [T, B, N, 3], labels [T, B, N], nocs [T, B, N, 3], pose
    `Pose` [T, B, P], corners [B, P, 2, 3]}, on `device` (CUDA unless
    given).  Returns (states, errors): `states` holds M = (T-1) * B rows,
    time-major, of the loss stacks' keys plus `init_pose`, the pose the
    tracker carried into each frame (`init_pose` for frame 1, the fit of
    frame t-1 after it); `errors` are the means of the rollout's own
    per-frame pose errors (`evaluate_track`), 0-d tensors."""
    device = resolve_device(device)
    step = make_track_step(cfg, coord_fn, rot_fn, device=device)
    _, aux = track_trajectory(step, init_pose, {"points": traj["points"]},
                              device=device)
    init_pose = init_pose.map(lambda x: x.to(device))
    carried = Pose(*(torch.cat([getattr(init_pose, f)[None],
                                getattr(aux.pose, f)[:-1]])
                     for f in ("rotation", "translation", "scale")))
    T1, B = traj["points"].shape[0] - 1, traj["points"].shape[1]

    def flat(x):
        return x.reshape((T1 * B,) + tuple(x.shape[2:]))

    corners = traj["corners"]
    states = {
        "points": flat(traj["points"][1:]),
        "labels": flat(traj["labels"][1:]),
        "nocs": flat(traj["nocs"][1:]),
        "pose": traj["pose"].map(lambda x: flat(x[1:])),
        "corners": flat(corners[None].expand((T1,) + tuple(corners.shape))),
        "init_pose": carried.map(flat),
    }
    gt_rest = traj["pose"].map(lambda x: x[1:])
    errs = evaluate_track(aux.pose, gt_rest, sym=cfg.obj.sym)
    return states, {k: torch.mean(v) for k, v in errs.items()}


def _on(draws, device):
    """A round's draws (dicts and lists of tensors, None) on `device`."""
    if isinstance(draws, dict):
        return {k: _on(v, device) for k, v in draws.items()}
    if isinstance(draws, list):
        return [_on(v, device) for v in draws]
    return None if draws is None else draws.to(device)


def _rows(tree, idx):
    """`tree` (a state dict of tensors and `Pose`s) at rows `idx`."""
    return {k: (v.map(lambda x: x[idx]) if isinstance(v, Pose) else v[idx])
            for k, v in tree.items()}


def make_finetune_round(cfg_track: Config, coord_trainer, rot_trainer,
                        pool: dict, *, traj_batch: int, traj_frames: int,
                        minibatch: int, plain_steps: int = 0,
                        motion_rad: float = 0.03,
                        freeze_coord: bool = False, device=None):
    """Build a fine-tune round.

    pool: `data/synthetic.py::geometry_pool`'s {npcs, labels, corners}
    (numpy or tensors; moved to `device`, CUDA unless given, once).
    Returns round_fn(coord_state, rot_state, draws=None, generator=None)
    -> (coord_state, rot_state, logs), the states trained in place.  A
    round samples `traj_batch` geometries, renders trajectories of
    `traj_frames` frames, tracks them with the states' nets, trains both
    nets once over the M = (traj_frames - 1) * traj_batch rollout states
    in shuffled minibatches (the remainder of M // minibatch dropped),
    then on `plain_steps` standard noise-perturbation batches.  With
    `freeze_coord` the CoordNet is not trained (its loss logs 0).

    The draws are `draws` (the structure `round_fn.draw(generator)` gives:
    "geo" [traj_batch] indices into the pool, "traj" the trajectories',
    "init" the init pose noise or None with `init_frame/gt`, "perm" a
    permutation of the M states, "train" each minibatch's {"coord",
    "rot"} train-step draws, "plain" each plain step's {"geo", "pose",
    "coord", "rot"}), else drawn from `generator` (on `device`), else
    round_fn raises.  `logs`: coord_loss, rot_loss, rot_rdiff (means over
    the minibatches) and rollout_<metric> (the rollout's mean errors),
    0-d tensors on the device."""
    device = resolve_device(device)
    obj = cfg_track.obj
    pool = {k: torch.as_tensor(v).to(device) for k, v in pool.items()}
    G, N = pool["labels"].shape
    P = obj.num_parts
    M = (traj_frames - 1) * traj_batch
    n_mb = M // minibatch
    if n_mb == 0:
        raise ValueError(f"minibatch {minibatch} exceeds rollout states {M}")

    def draw_round(generator: torch.Generator) -> dict:
        dev = generator.device

        def randint(n):
            return torch.randint(0, G, (n,), generator=generator, device=dev)

        geo = randint(traj_batch)
        draws = {"geo": geo,
                 "traj": draw_trajectory_batch(traj_batch, N, P,
                                               traj_frames, generator),
                 "init": (None if cfg_track.track.init_frame_gt else
                          draw_pose_noise((traj_batch, P),
                                          cfg_track.perturb.kind, generator)),
                 # a permutation from sorted uniforms: torch.randperm on
                 # the card synchronises the host
                 "perm": torch.argsort(torch.rand(M, generator=generator,
                                                  device=dev))}
        # the GT labels of the states, time-major: row t * B + b is geometry b
        labels = pool["labels"].to(dev)[geo].repeat(traj_frames - 1, 1)
        perm = draws["perm"][:n_mb * minibatch].reshape(n_mb, minibatch)
        draws["train"] = [
            {"coord": (None if freeze_coord else coord_trainer.draw_for(
                labels[perm[i]], True, generator)),
             "rot": rot_trainer.draw_for(labels[perm[i]], True, generator)}
            for i in range(n_mb)]
        draws["plain"] = []
        for _ in range(plain_steps):
            pidx = randint(minibatch)
            plabels = pool["labels"].to(dev)[pidx]
            draws["plain"].append({
                "geo": pidx,
                "pose": draw_pose_batch(minibatch, N, P, generator),
                "coord": (None if freeze_coord else coord_trainer.draw_for(
                    plabels, False, generator)),
                "rot": rot_trainer.draw_for(plabels, False, generator)})
        return draws

    def round_fn(coord_state, rot_state, draws: dict | None = None,
                 generator: torch.Generator | None = None):
        if draws is None:
            if generator is None:
                raise ValueError("a fine-tune round needs its draws (draws=) "
                                 "or a torch.Generator")
            draws = draw_round(generator)
        draws = _on(draws, device)
        idx = draws["geo"]
        traj = device_trajectory_batch(
            pool["npcs"][idx], pool["labels"][idx], pool["corners"][idx],
            obj, num_frames=traj_frames, draws=draws["traj"],
            motion_rad=motion_rad)
        init_pose = init_pose_from_gt(traj["pose"][0], cfg_track,
                                      noise=draws["init"])
        coord_mod, rot_mod = coord_state.module, rot_state.module
        coord_mod.eval()
        rot_mod.eval()
        with torch.no_grad():
            states, roll_errs = collect_states(cfg_track, coord_mod, rot_mod,
                                               traj, init_pose, device=device)
        perm = draws["perm"][:n_mb * minibatch].reshape(
            n_mb, minibatch)

        logs = {"coord_loss": [], "rot_loss": [], "rot_rdiff": []}
        for i in range(n_mb):
            mb = _rows(states, perm[i])
            if freeze_coord:
                # rotation-only fine-tuning: the CoordNet passes through
                closs = torch.zeros((), device=device)
            else:
                _, cl, _ = coord_trainer.train_step(
                    coord_state, mb, draws=draws["train"][i]["coord"])
                closs = cl["total_loss"]
            _, rl, rmet = rot_trainer.train_step(
                rot_state, mb, draws=draws["train"][i]["rot"])
            logs["coord_loss"].append(closs)
            logs["rot_loss"].append(rl["total_loss"])
            logs["rot_rdiff"].append(rmet["rdiff"])
        logs = {k: torch.mean(torch.stack(v)) for k, v in logs.items()}

        for plain in draws["plain"]:
            pidx = plain["geo"]
            pb = device_pose_batch(pool["npcs"][pidx], pool["labels"][pidx],
                                   pool["corners"][pidx], obj,
                                   draws=plain["pose"])
            if not freeze_coord:
                coord_trainer.train_step(coord_state, pb,
                                         draws=plain["coord"])
            rot_trainer.train_step(rot_state, pb, draws=plain["rot"])

        logs.update({f"rollout_{k}": v for k, v in roll_errs.items()})
        return coord_state, rot_state, logs

    round_fn.draw = draw_round
    return round_fn
