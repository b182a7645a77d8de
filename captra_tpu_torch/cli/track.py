"""Tracking entry point (counterpart of `captra_tpu/cli/track.py`).

    python -m captra_tpu_torch.cli.track --coord_exp/dir=<coord exp> \\
        --experiment_dir=<rot exp> [--basepath=<dataset root>] \\
        [--mode_name=<split>] [--synthetic_data] [--save] [flags]

Loads a CoordNet experiment's and a RotNet experiment's checkpoints (the
JAX package's pickle files, `training/checkpoint.py`), tracks each batch of
trajectories frame by frame on the card, prints each batch's time and
errors and the averages, and with `--save` writes one result pickle a
trajectory for `captra_tpu_torch.cli.evaluate` (or the JAX package's).

The trajectories are the dataset on disk under the object config's
basepath (`data/factory.py`: NOCS, SAPIEN renders, BMVC, captured real),
split `--mode_name` or else `default_track_mode` (NOCS `real_test`, SAPIEN
`test_seq` where `render_seq/` exists, else `test`): whole tracks for
NOCS, BMVC and `real_test`, `obj/num_frames` chunks otherwise, batched
`--batch_size` at a time; or, with `--synthetic_data`, 4 generated
trajectories of 20 frames.

Where the port differs from the JAX CLI:

- the frame-0 noise (`init_frame/gt` false) and the OTF crop's shifts come
  from one `torch.Generator` seeded by `seed`, drawn in sequence order;
  the JAX `jax.random.split` stream cannot be reproduced (the readers'
  own draws, from their numpy seeds, are the JAX readers');
- no length buckets: the JAX CLI pads each trajectory to a bucket length
  to share one XLA compile; an eager loop compiles nothing, so the port
  tracks exactly T frames;
- the saved GT corners are each trajectory's own (`synthetic_sequences`
  yields them as [1, B, P, 2, 3], the real-data layout), where the JAX CLI
  indexes the synthetic layout [B, P, 2, 3] as if it were that one.

Checkpoints of either format (pickle files, orbax directories) load.
`--num_devices N` (default: the cards, or 1 on the CPU) tracks over N
ranks of this machine (`parallel/mesh.py`; on CUDA one card a rank, more
ranks than cards raise `ValueError`): a batch of B trajectories with
B % N == 0 is sharded over the ranks, any other is tracked by rank 0
alone, as the JAX CLI leaves such a batch unsharded.  The draws are made
for the whole batch before it is sharded; rank 0 gathers the poses and
outputs in trajectory order and prints, evaluates and saves as a
one-rank run does (its frames/s counts every rank's frames over the wall
time).  `main(argv, device="cpu")` runs on the CPU; without it the card
is required.
"""
from __future__ import annotations

import argparse
import time
from os.path import join as pjoin

import numpy as np
import torch

from captra_tpu_torch.cli.args import add_args, config_overrides
from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.results import (
    corners_from_track_aux, save_track_result,
)
from captra_tpu_torch.tracking.tracker import (
    evaluate_track, init_pose_from_cloud, init_pose_from_gt,
    make_track_step, search_init_orientation, track_trajectory,
)
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax,
)

# frames of the untimed warm-up per batch size (one tracked step: the
# first call builds the FPS kernels)
WARMUP_FRAMES = 2
# seed of the step's own generator (the RANSAC draws of `fit_ransac`)
STEP_SEED = 13


def load_variables(cfg, args):
    """The coord and rot experiments' checkpoints (the newest, or the pinned
    epochs) as flax variable trees."""
    coord_dir = pjoin(cfg.coord_exp_dir, "ckpt")
    rot_dir = pjoin(cfg.experiment_dir, "ckpt")
    coord_path = ckpt.latest_checkpoint(
        coord_dir, cfg.coord_resume_epoch if cfg.coord_resume_epoch >= 0
        else None)
    rot_path = ckpt.latest_checkpoint(
        rot_dir, args.resume_epoch if args.resume_epoch >= 0 else None)
    if not coord_path or not rot_path:
        raise FileNotFoundError(
            f"checkpoints not found: coord={coord_path} rot={rot_path}")
    return ckpt.load_track_variables(coord_path, rot_path)


def build_step(cfg, cv, rv, device=None):
    """The tracking step over the nets built from flax variables cv / rv on
    `device` (CUDA unless given), in eval mode; the CoordNet rides on it as
    `step.coord_fn` for the frame-0 orientation search."""
    device = resolve_device(device)
    coord = coordnet_from_flax(cfg, cv, device=device)
    rotn = rotnet_from_flax(cfg, rv, device=device)
    generator = torch.Generator(device=device).manual_seed(STEP_SEED)
    step = make_track_step(cfg, coord, rotn, device=device,
                           generator=generator)
    step.coord_fn = coord
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first(batch: dict, key: str):
    value = batch.get(key)
    return None if value is None else torch.as_tensor(np.asarray(value[0]))


def track_sequences(cfg, step, sequences, save: bool = False,
                    no_eval: bool = False, seed: int = 0, device=None,
                    dp: mesh.DataParallel | None = None):
    """Track `sequences`, an iterator of (name | names-tuple, batch) with
    leading [T, B, ...]: the B trajectories of a batch track together.
    A batch carries points (and labels), or with `track_cfg/nocs_otf` depth
    and mask (and the crop's shift [T, B], else drawn here; and the NOCS-2D
    detections; a batch without depth then raises); "pose" (a `Pose` [T,
    B, P]) and "corners" [T or 1, B, P, 2, 3] when it has GT.  Returns {metric: [per-trajectory average]}.

    Under `dp` every rank is given the same sequences: a batch whose B
    the ranks divide is sharded over them and gathered on rank 0, any
    other is tracked by rank 0 alone; only rank 0 prints, evaluates and
    saves (the other ranks return {})."""
    device = resolve_device(device)
    lead = dp is None or dp.rank == 0
    gen = torch.Generator().manual_seed(seed)
    all_avgs, total_frames, total_time = {}, 0, 0.0
    warmed: set[int] = set()
    for name, batch in sequences:
        names = (name,) if isinstance(name, str) else tuple(name)
        if cfg.track.nocs_otf and "depth" not in batch:
            raise ValueError(f"{'|'.join(names)}: track_cfg/nocs_otf crops "
                             "each frame from its depth image, and this "
                             "batch has none")
        gt = batch.get("pose")
        if gt is not None:
            gt = gt.map(lambda x: torch.as_tensor(np.asarray(x)))
            init_pose = init_pose_from_gt(
                gt[0], cfg, generator=gen,
                crop_translation=_first(batch, "crop_translation"),
                crop_scale=_first(batch, "crop_scale"))
        else:
            # a GT-less capture: frame 0 from the cloud itself, then the
            # orientation search when asked for
            points0 = torch.as_tensor(np.asarray(batch["points"][0]))
            init_pose = init_pose_from_cloud(points0, cfg.obj.num_parts,
                                             cfg.data_radius, device=device)
            coord_fn = getattr(step, "coord_fn", None)
            if cfg.track.init_search > 0 and coord_fn is not None:
                init_pose = search_init_orientation(coord_fn, points0,
                                                    init_pose, cfg,
                                                    device=device)
        if cfg.track.nocs_otf:
            T, B = batch["depth"].shape[:2]
            H, W = batch["depth"].shape[-2:]
            shift = batch.get("shift")
            if shift is None:
                shift = torch.randint(0, H * W, (T, B), generator=gen)
            frames = {"depth": batch["depth"], "mask": batch["mask"],
                      "shift": shift}
            if cfg.track.nocs2d_label and "det_masks" in batch:
                for k in ("det_masks", "det_boxes", "det_valid"):
                    frames[k] = batch[k]
        else:
            T = batch["points"].shape[0]
            frames = {"points": batch["points"]}
            if cfg.track.gt_label:
                frames["labels"] = batch["labels"]
        frames = {k: torch.as_tensor(np.asarray(v)).to(device)
                  for k, v in frames.items()}
        B = len(names)
        sharded = dp is not None and B % dp.world == 0
        if sharded:
            init_pose = mesh.shard_batch(init_pose, dp.rank, dp.world)
            frames = mesh.shard_batch(frames, dp.rank, dp.world,
                                      batch_dim=1)
        elif not lead:
            continue
        b_local = B // dp.world if sharded else B
        if b_local not in warmed:
            # one untimed warm-up per batch size: the first call builds
            # the FPS kernels
            track_trajectory(step, init_pose,
                             {k: v[:WARMUP_FRAMES] for k, v in frames.items()},
                             device=device)
            _sync(device)
            warmed.add(b_local)
        _sync(device)
        if sharded:
            dp.barrier()
        t0 = time.perf_counter()
        _, aux = track_trajectory(step, init_pose, frames, device=device)
        if sharded:
            aux = mesh.gather_batch(aux, dp, batch_dim=1)
        _sync(device)
        dt = time.perf_counter() - t0
        if not lead:
            continue
        total_frames += (T - 1) * B
        total_time += dt
        print(f"{'|'.join(names)}: {T - 1} frames x {B} in {dt:.3f}s "
              f"({(T - 1) * B / dt:.1f} fps)")

        if gt is not None and not no_eval:
            gt_rest = gt.map(lambda x: x[1:].to(device))
            errs = evaluate_track(aux.pose, gt_rest, sym=cfg.obj.sym)
            for b, nm in enumerate(names):
                avg = {k: float(torch.mean(v[:, b])) for k, v in errs.items()}
                for k, v in avg.items():
                    all_avgs.setdefault(k, []).append(v)
                print(f"  {nm}: " + "  ".join(
                    f"{k}={v:.4f}" for k, v in avg.items()))

        if save:
            pred_corners_all = corners_from_track_aux(aux, cfg.obj.num_parts)
            for b, nm in enumerate(names):
                gt_corners = (np.asarray(batch["corners"][0, b])
                              if "corners" in batch else None)
                save_track_result(
                    pjoin(cfg.experiment_dir, "results"),
                    nm.replace("/", "_"), aux.pose.map(lambda x: x[:, b]),
                    None if gt is None else gt.map(lambda x: x[1:, b]),
                    pred_corners_all[:, b], gt_corners,
                    # tracked frames are 1..T-1 (frame 0's pose is given)
                    frame_nums=[[t] for t in range(1, T)])
    if total_time > 0:
        print(f"TOTAL: {total_frames} frames, "
              f"{total_frames / total_time:.1f} fps")
    if all_avgs:
        print("AVG: " + "  ".join(
            f"{k}={np.mean(v):.4f}" for k, v in sorted(all_avgs.items())))
    return all_avgs


def synthetic_sequences(cfg, count: int = 4, num_frames: int = 20):
    """Generated trajectories, `cfg.batch_size` a batch, with the JAX
    generator's numbers; "corners" in the real-data layout [1, B, P, 2, 3],
    so corners[0, b] is trajectory b's own box."""
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    B = max(1, min(cfg.batch_size, count))
    for start in range(0, count, B):
        seeds = range(start, min(start + B, count))
        trs = [make_trajectory(seed=s, obj=cfg.obj, num_frames=num_frames,
                               num_points=cfg.num_points) for s in seeds]
        names = tuple(f"synthetic/{s:04d}" for s in seeds)
        batch = batch_trajectories(trs)
        batch["corners"] = batch["corners"][None]
        yield (names[0] if len(names) == 1 else names), batch


def dataset_sequences(cfg, mode: str | None = None):
    """The trajectory batches of split `mode` (else `default_track_mode`)
    of the dataset under `cfg.obj.basepath`: whole tracks for NOCS, BMVC
    and `real_test`, `cfg.obj.num_frames` chunks otherwise (reference
    SequenceData, dataset.py:138-151), `cfg.batch_size` a batch."""
    from captra_tpu_torch.data.factory import default_track_mode, make_dataset
    from captra_tpu_torch.data.loader import sequence_batches
    mode = mode or default_track_mode(cfg)
    chunked = not (cfg.obj.nocs_data or "bmvc" in mode
                   or mode == "real_test")
    dataset = make_dataset(cfg, mode)
    num_frames = cfg.obj.num_frames if chunked else None
    batches = sequence_batches(dataset, num_frames,
                               batch_size=cfg.batch_size)
    if cfg.track.nocs_otf:
        return _with_depth(dataset, batches, num_frames)
    return batches


def _with_depth(dataset, batches, num_frames):
    """`batches`, raising `FileNotFoundError` at the first one without
    depth images (`track_cfg/nocs_otf` crops every frame from its own),
    naming the depth path of the first frame that read none."""
    tracks = dataset.track_index()
    for name, batch in batches:
        if "depth" not in batch:
            first = name if isinstance(name, str) else name[0]
            track, chunk = first.rsplit("/", 1)
            idxs = tracks[track]
            if num_frames is not None:
                idxs = idxs[int(chunk) * num_frames:][:num_frames]
            meta = next(m for m in (dataset[int(i)]["meta"] for i in idxs)
                        if "pre_fetched" not in m)
            raise FileNotFoundError(
                f"{first}: track_cfg/nocs_otf needs each frame's depth "
                f"image, and frame {meta['path']} has none: depth path "
                f"{meta.get('depth_path') or '(none recorded)'!r} is no "
                "file (a NOCS frame records its depth image's absolute "
                "path when it is preprocessed)")
        yield name, batch


def parse(argv=None):
    """(args, cfg) of a track command line."""
    parser = add_args(argparse.ArgumentParser("captra-tpu-torch track"))
    args = parser.parse_args(argv)
    return args, get_config(args.config, config_overrides(args),
                            args.config_dir)


def main(argv=None, device=None):
    """Track as the command line says; returns rank 0's {metric:
    [per-trajectory average]}."""
    from captra_tpu_torch.cli.train import num_ranks
    device = resolve_device(device)
    args, cfg = parse(argv)
    n = num_ranks(args.num_devices, None, device)
    cv, rv = load_variables(cfg, args)
    if n > 1:
        return mesh.launch(_rank_main, n, device, args=(argv, cv, rv))[0]
    return run_tracking(args, cfg, cv, rv, device)


def _rank_main(rank: int, world: int, device: str, argv, cv, rv) -> dict:
    args, cfg = parse(argv)
    return run_tracking(args, cfg, cv, rv, torch.device(device),
                        mesh.data_parallel_mesh())


def run_tracking(args, cfg, cv, rv, device, dp=None) -> dict:
    """Track as `args` say with the nets of flax variables cv / rv on
    `device`, over the group `dp` (rank 0 gathers, prints and saves);
    returns the per-trajectory averages (rank 0's)."""
    step = build_step(cfg, cv, rv, device=device)
    sequences = (synthetic_sequences(cfg) if args.synthetic_data
                 else dataset_sequences(cfg, args.mode_name))
    return track_sequences(cfg, step, sequences, save=args.save,
                           no_eval=args.no_eval, device=device, dp=dp)


if __name__ == "__main__":
    main()
