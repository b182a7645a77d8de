"""End-to-end offline NOCS preprocessing: a raw NOCS release in, the
`render/` tree that `data/nocs.py` reads out (counterpart of
`captra_tpu/data/preproc_pipeline.py`).

Stages (the reference's generate_all.py:39-60 order), over the raw layout

    <raw_root>/nocs_full/<data_type>/<track>/<prefix>_{color,depth,coord,
                                                       mask}.png, _meta.txt
    <raw_root>/obj_models/...                    # .obj sources for corners

1. poses   -> <raw_root>/nocs_full/<data_type>/<track>/<prefix>_pose.pkl
2. lists   -> <raw_root>/instance_list/<data_type>/<cls>/<instance>.txt
3. corners -> <raw_root>/model_corners/<instance>.npy      # [2, 3] NPCS
4. gather  -> <raw_root>/render/<data_type>/<cls>/<instance>/<folder>/data/
              <frame>.npz, then the link render/test -> val

Each stage fans out over `preproc_nocs.run_parallel` and overwrites what it
wrote before.  The pose stage seeds one `RandomState(seed)` per call of
`gt_poses_for_tracks`, which runs once per chunk of track folders, so the
poses depend on `num_proc`, as in the JAX package.  A frame whose files
are missing is skipped; a file that is there but does not decode raises.
"""
from __future__ import annotations

import glob
import os
import pickle
from os.path import join as pjoin

import numpy as np

from captra_tpu_torch.data import image_io
from captra_tpu_torch.data.preproc_nocs import (
    REAL_INTRINSICS, SYNTHETIC_INTRINSICS, crop_instance_frame,
    frame_poses, instance_occurrences, read_coord_map, read_depth,
    run_parallel,
)

SYN_TYPES = ("train", "val")
REAL_TYPES = ("real_train", "real_test")
ALL_TYPES = SYN_TYPES + REAL_TYPES


def _intrinsics(data_type: str) -> np.ndarray:
    return REAL_INTRINSICS if data_type in REAL_TYPES else SYNTHETIC_INTRINSICS


def _is_real(data_type: str) -> bool:
    return data_type in REAL_TYPES


def _is_flip(data_type: str) -> bool:
    # synthetic CAMERA frames are mirrored (get_gt_poses.py:105,
    # gather_instance_data.py:161)
    return data_type in SYN_TYPES


def _frame_prefixes(track_dir: str) -> list[str]:
    return sorted(f[:4] for f in os.listdir(track_dir)
                  if f.endswith("color.png"))


def dilate(img: np.ndarray, kernel_size: int) -> np.ndarray:
    """`cv2.dilate(img, np.ones((2k, 2k)))` of a 2-D array, k =
    `kernel_size`: an output pixel is the max of the input over row and
    column offsets -k .. k-1 (the even kernel's anchor is its centre (k,
    k)), pixels outside the image taking no part."""
    out = img
    for axis in (0, 1):
        grown = np.zeros_like(out)
        n = out.shape[axis]
        for o in range(-kernel_size, kernel_size):
            dst = [slice(None)] * 2
            src = [slice(None)] * 2
            dst[axis] = slice(max(-o, 0), n - max(o, 0))
            src[axis] = slice(max(o, 0), n + min(o, 0))
            np.maximum(grown[tuple(dst)], out[tuple(src)],
                       out=grown[tuple(dst)])
        out = grown
    return out


def remove_border(mask: np.ndarray, kernel_size: int = 2) -> np.ndarray:
    """Grow the 255 (no-instance) region by `dilate`, so real-capture mask
    borders do not leak mixed depth pixels into pose fitting
    (nocs_utils.py:44-53)."""
    grow = dilate((mask == 255).astype(np.uint8), kernel_size)
    out = mask.copy()
    out[grow.astype(bool)] = 255
    return out


def _frame_files(tdir: str, prefix: str, names) -> list[str] | None:
    """The paths of `<prefix>_<name>` for each name, or None if one is
    missing."""
    paths = [pjoin(tdir, f"{prefix}_{n}") for n in names]
    return paths if all(os.path.exists(p) for p in paths) else None


# ---------------------------------------------------------------------------
# stage 1: per-frame GT pose recovery (get_gt_poses.py:37-82)
# ---------------------------------------------------------------------------

def gt_poses_for_tracks(raw_path: str, tracks: list[str], data_type: str,
                        seed: int = 0) -> int:
    """Write `<prefix>_pose.pkl` beside every frame of the given track
    folders.  Returns the number of frames processed."""
    intrinsics = _intrinsics(data_type)
    flip, real = _is_flip(data_type), _is_real(data_type)
    rng = np.random.RandomState(seed)
    done = 0
    for track in tracks:
        tdir = pjoin(raw_path, track)
        if not os.path.isdir(tdir):
            continue
        for prefix in _frame_prefixes(tdir):
            files = _frame_files(tdir, prefix, ("depth.png", "coord.png",
                                                "mask.png", "meta.txt"))
            if files is None:
                continue
            depth_path, coord_path, mask_path, meta = files
            depth = read_depth(depth_path)
            mask = image_io.read_png(mask_path)[:, :, 2]
            if flip:
                depth, mask = depth[:, ::-1], mask[:, ::-1]
            if real:
                mask = remove_border(mask, kernel_size=2)
            # read_coord_map applies the flip, channel and z-sign
            # conventions (get_gt_poses.py:73-76)
            coord = read_coord_map(coord_path, flip)
            with open(meta) as f:
                num_instances = sum(1 for line in f if line.strip())
            poses = frame_poses(depth, coord, mask, num_instances,
                                intrinsics, rng=rng)
            with open(pjoin(tdir, f"{prefix}_pose.pkl"), "wb") as f:
                pickle.dump(poses, f)
            done += 1
    return done


# ---------------------------------------------------------------------------
# stage 2: instance occurrence lists (get_instance_list.py:63-78)
# ---------------------------------------------------------------------------

def write_instance_lists(raw_path: str, data_type: str, list_path: str,
                         min_points: int = 50) -> dict:
    """instance_list/<data_type>/<cls>/<instance>.txt, one `track/prefix`
    a line."""
    folders = sorted(os.listdir(raw_path))
    occ = instance_occurrences(raw_path, folders, real=_is_real(data_type),
                               min_points=min_points)
    out_root = pjoin(list_path, data_type)
    for cls_id, instances in occ.items():
        cdir = pjoin(out_root, str(cls_id))
        os.makedirs(cdir, exist_ok=True)
        for inst_id, frames in instances.items():
            with open(pjoin(cdir, f"{inst_id}.txt"), "w") as f:
                f.writelines(line + "\n" for line in frames)
    return occ


# ---------------------------------------------------------------------------
# stage 3: model corners from the released .obj meshes
# ---------------------------------------------------------------------------

def obj_vertices(path: str) -> np.ndarray:
    """Vertex positions from a Wavefront OBJ ('v x y z' lines only)."""
    verts = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float64)


def write_model_corners(model_root: str, out_path: str,
                        instances: list[str] | None = None) -> list[str]:
    """model_corners/<instance>.npy = float32 [2, 3] vertex min / max of
    obj_models/**/{<instance>.obj | <instance>/model.obj} (the reference
    reads them pre-built, nocs_dataset.py:56)."""
    os.makedirs(out_path, exist_ok=True)
    candidates = glob.glob(pjoin(model_root, "**", "*.obj"), recursive=True)
    written = []
    for obj_path in sorted(candidates):
        name = os.path.basename(obj_path)[:-4]
        if name == "model":  # CAMERA layout: <instance>/model.obj
            name = os.path.basename(os.path.dirname(obj_path))
        if instances is not None and name not in instances:
            continue
        verts = obj_vertices(obj_path)
        if len(verts) == 0:
            continue
        corners = np.stack([verts.min(0), verts.max(0)]).astype(np.float32)
        np.save(pjoin(out_path, f"{name}.npy"), corners)
        written.append(name)
    return written


# ---------------------------------------------------------------------------
# stage 4: per-instance gathering (gather_instance_data.py:27-128)
# ---------------------------------------------------------------------------

def gather_instance(raw_path: str, list_path: str, model_path: str,
                    output_path: str, instance: str, data_type: str,
                    img_per_folder: int = 100) -> int:
    """Crop every listed frame of one instance into the render tree:
    synthetic -> <instance>/<folder:04d>/data/<img:02d>.npz,
    `img_per_folder` a folder; real -> <instance>/<track>/data/<prefix>.npz
    and a meta.txt a track naming its raw folder.  Each npz holds all_dict
    = {points, labels, pose, path (of the depth PNG)}.  Returns the frames
    written."""
    intrinsics = _intrinsics(data_type)
    flip, real = _is_flip(data_type), _is_real(data_type)
    corners = np.load(pjoin(model_path, f"{instance}.npy"))
    with open(pjoin(list_path, f"{instance}.txt")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    inst_root = pjoin(output_path, instance)
    folder_num, img_num = 0, -1
    track_dirs: dict[str, str] = {}
    written = 0
    suffix = "depth" if real else "composed"
    for line in lines:
        track, prefix = line.split("/")[:2]
        tdir = pjoin(raw_path, track)
        files = _frame_files(tdir, prefix, (f"{suffix}.png", "mask.png",
                                            "meta.txt", "pose.pkl"))
        if files is None:
            continue
        depth_path, mask_path, meta_path, pose_path = files
        depth = read_depth(depth_path)
        mask = image_io.read_png(mask_path)[:, :, 2]
        if flip:
            depth, mask = depth[:, ::-1], mask[:, ::-1]
        inst_num = -1
        with open(meta_path) as f:
            for meta_line in f:
                parts = meta_line.split()
                if not parts:
                    continue
                # real meta ids may carry an extension or a path
                # (get_instance_list.py:37-38)
                mid = parts[-1].split(".")[0].replace("/", "_") if real \
                    else parts[-1]
                if mid == instance:
                    inst_num = int(parts[0])
                    break
        with open(pose_path, "rb") as f:
            pose_dict = pickle.load(f)
        if inst_num not in pose_dict:
            continue
        pose = pose_dict[inst_num]
        out = crop_instance_frame(depth, mask, inst_num, pose, corners,
                                  intrinsics)
        if out is None:
            continue
        data_dict = {"points": out["points"], "labels": out["labels"],
                     "pose": pose, "path": depth_path}
        if real:
            ddir = pjoin(inst_root, track, "data")
            os.makedirs(ddir, exist_ok=True)
            track_dirs[track] = tdir
            np.savez_compressed(pjoin(ddir, f"{prefix}.npz"),
                                all_dict=data_dict)
        else:
            img_num += 1
            if img_num >= img_per_folder:
                folder_num += 1
                img_num = 0
            ddir = pjoin(inst_root, f"{folder_num:04d}", "data")
            os.makedirs(ddir, exist_ok=True)
            np.savez_compressed(pjoin(ddir, f"{img_num:02d}.npz"),
                                all_dict=data_dict)
        written += 1
    # each track's raw folder, which the OTF path reads depth back from
    # (gather_instance_data.py:123-128 writes one file an instance; a file
    # a track is what nocs_dataset.py reads)
    for track, tdir in track_dirs.items():
        with open(pjoin(inst_root, track, "meta.txt"), "w") as f:
            print(tdir, file=f)
    return written


def gather_category(raw_path: str, list_root: str, model_path: str,
                    render_root: str, category: int, data_type: str,
                    num_proc: int = 1, img_per_folder: int = 100) -> list[str]:
    """Gather every instance of one (data_type, category) that has model
    corners, over `num_proc` processes.  Returns the instances."""
    list_path = pjoin(list_root, data_type, str(category))
    if not os.path.isdir(list_path):
        return []
    output_path = pjoin(render_root, data_type, str(category))
    os.makedirs(output_path, exist_ok=True)
    instances = sorted(s[:-4] for s in os.listdir(list_path)
                       if s.endswith(".txt"))
    instances = [i for i in instances
                 if os.path.exists(pjoin(model_path, f"{i}.npy"))]

    def work(chunk):
        for inst in chunk:
            gather_instance(raw_path, list_path, model_path, output_path,
                            inst, data_type, img_per_folder)

    run_parallel(work, instances, num_proc)
    return instances


# ---------------------------------------------------------------------------
# the full pipeline (generate_all.py:39-60)
# ---------------------------------------------------------------------------

def run_pipeline(root_dset: str, data_types=ALL_TYPES,
                 categories=range(1, 7), num_proc: int = 1,
                 img_per_folder: int = 100, stages=("poses", "lists",
                                                    "corners", "gather"),
                 log=print) -> None:
    """The raw NOCS release at <root_dset> -> the render tree: the given
    stages in order, over `data_types` and `categories`, then the link
    render/test -> val."""
    ori_path = pjoin(root_dset, "nocs_full")
    list_path = pjoin(root_dset, "instance_list")
    model_path = pjoin(root_dset, "model_corners")
    render_path = pjoin(root_dset, "render")

    if "poses" in stages:
        for dt in data_types:
            raw = pjoin(ori_path, dt)
            tracks = sorted(os.listdir(raw)) if os.path.isdir(raw) else []
            log(f"[poses] {dt}: {len(tracks)} track folders")
            run_parallel(
                lambda chunk, raw=raw, dt=dt:
                    gt_poses_for_tracks(raw, chunk, dt),
                tracks, num_proc)

    if "lists" in stages:
        for dt in data_types:
            raw = pjoin(ori_path, dt)
            if not os.path.isdir(raw):
                continue
            occ = write_instance_lists(raw, dt, list_path)
            log(f"[lists] {dt}: " + " ".join(
                f"cls{c}={len(v)}" for c, v in occ.items() if v))

    if "corners" in stages:
        written = write_model_corners(pjoin(root_dset, "obj_models"),
                                      model_path)
        log(f"[corners] {len(written)} models")

    if "gather" in stages:
        for dt in data_types:
            for cat in categories:
                insts = gather_category(pjoin(ori_path, dt), list_path,
                                        model_path, render_path, cat, dt,
                                        num_proc, img_per_folder)
                if insts:
                    log(f"[gather] {dt} cls{cat}: {len(insts)} instances")
        # the val render tree doubles as test (generate_all.py:59-60)
        val_dir, test_dir = pjoin(render_path, "val"), pjoin(render_path,
                                                             "test")
        if os.path.isdir(val_dir) and not os.path.exists(test_dir):
            os.symlink("val", test_dir)
            log("[link] render/test -> val")
