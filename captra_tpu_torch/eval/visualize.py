"""Tracking visualisers (counterpart of `captra_tpu/eval/visualize.py`):
3D plots of clouds and posed boxes, and the NOCS scene overlay of each
tracked instance's projected box on the scene's colour or depth frames.

They read the result pickles of `tracking/results.py` (the port's or the
JAX package's).  The 3D plots call matplotlib as the JAX functions do
(Agg, the same figure sizes, dpi 80, `bbox_inches="tight"`); matplotlib is
imported when a plot is drawn, and without it the call raises
`ImportError` naming it.  The overlay needs no OpenCV: `cv2.line` is
`raster.draw_line` (pixel for pixel), `cv2.imread` / `cv2.imwrite` are
`data/image_io.read_png` / `write_png`, and the posed boxes come from
`pose/bbox.posed_bbox_from_part` on CPU tensors.
"""
from __future__ import annotations

import os
import pickle
import re
from os.path import join as pjoin

import numpy as np
import torch

from captra_tpu_torch.data import image_io
from captra_tpu_torch.eval.raster import draw_line

# box wireframe edges for the bbox_from_corners vertex ordering
# (vertex bits: x = bit from (i%4)//2, y = i//4, z = i%2)
_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
          (4, 5), (4, 6), (5, 7), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the 3D plots need the matplotlib package, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_point_clouds(pt_lists, save_path: str | None = None,
                      titles=None, limits=None):
    """Rows of grouped 3D point clouds.  pt_lists: list of list of
    [N, 3]."""
    plt = _plt()
    n = len(pt_lists)
    fig = plt.figure(figsize=(5 * n, 5))
    for i, groups in enumerate(pt_lists):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        for pts in groups:
            pts = np.asarray(pts)
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1)
        if titles:
            ax.set_title(titles[i])
        if limits:
            ax.set_xlim(*limits[0])
            ax.set_ylim(*limits[1])
            ax.set_zlim(*limits[2])
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        fig.savefig(save_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_tracked_boxes_3d(points: np.ndarray, boxes: np.ndarray,
                          gt_boxes: np.ndarray | None = None,
                          save_path: str | None = None):
    """Cloud and predicted (and GT) posed box wireframes of one frame.
    boxes: [P, 8, 3]."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, c="gray", alpha=0.5)

    def draw(bx, color):
        for part in np.asarray(bx):
            for a, b in _EDGES:
                ax.plot(*zip(part[a], part[b]), c=color, linewidth=1)

    draw(boxes, "tab:blue")
    if gt_boxes is not None:
        draw(gt_boxes, "tab:green")
    if save_path:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        fig.savefig(save_path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return save_path


def project_box_2d(box: np.ndarray, intrinsics: np.ndarray,
                   image_height: int) -> np.ndarray:
    """Posed box vertices [8, 3] -> pixel (row, col) [8, 2] with the NOCS
    projection conventions (the camera looks down -z; rows flipped)."""
    pts = box * 1000.0
    pts = -pts / pts[:, -1:]
    pts[:, -1] = -pts[:, -1]
    uv = (intrinsics @ pts.T).T[:, :2]
    rc = np.stack([image_height - uv[:, 1], uv[:, 0]], axis=-1)
    return rc


def draw_boxes_on_image(image: np.ndarray, boxes: np.ndarray,
                        intrinsics: np.ndarray, color=(255, 80, 0),
                        thickness: int = 2) -> np.ndarray:
    """A copy of an RGB (or depth-as-RGB) image with each box's projected
    wireframe drawn on it."""
    img = np.ascontiguousarray(image).copy()
    H = img.shape[0]
    for box in np.asarray(boxes):
        rc = project_box_2d(box, intrinsics, H).astype(np.int32)
        for a, b in _EDGES:
            draw_line(img, (rc[a, 1], rc[a, 0]), (rc[b, 1], rc[b, 0]),
                      color, thickness)
    return img


def _pose(poses: dict, index=None):
    from captra_tpu_torch.pose.part_dof import Pose
    return Pose(**{k: torch.as_tensor(np.asarray(v if index is None
                                                 else v[index]))
                   for k, v in poses.items()})


def _posed_boxes(pose, corners) -> np.ndarray:
    from captra_tpu_torch.pose.bbox import posed_bbox_from_part
    return posed_bbox_from_part(
        pose, torch.as_tensor(np.asarray(corners))).numpy()


def visualize_scene_images(results_dir: str, img_dir: str, scene: str,
                           out_dir: str | None = None,
                           intrinsics: np.ndarray | None = None,
                           depth: bool = False, draw_gt: bool = False,
                           color=(255, 80, 0), gt_color=(0, 200, 0)):
    """Scene walkthrough: for every frame of `scene`, each tracked
    instance's posed predicted box projected onto the scene's RGB (or
    depth) image, written as `<out_dir>/<frame>.png`; returns the paths.

    Reads `results_dir/data/*.pkl` whose names hold the scene id as a whole
    `_`-separated token, and NOCS-layout images
    `img_dir/<scene>/<frame>_color.png` (or `_depth.png`; 4-digit or
    unpadded frame numbers).  Frames come from each pickle's `frame_nums`
    (1..T without them).  A frame whose predicted corners are missing or
    non-finite falls back to the GT corners (skipped without GT)."""
    if intrinsics is None:
        from captra_tpu_torch.data.preprocess import NOCS_REAL_INTRINSICS
        intrinsics = np.asarray(NOCS_REAL_INTRINSICS)

    out_dir = out_dir or pjoin(results_dir, "vis", scene)
    data_dir = pjoin(results_dir, "data")
    # exact token match: "scene_1" must not pull in "scene_10"
    pat = re.compile(r"(^|_)" + re.escape(scene) + r"(_|$)")
    instances = {}
    for raw in sorted(os.listdir(data_dir)):
        if raw.endswith(".pkl") and pat.search(raw[:-4]):
            with open(pjoin(data_dir, raw), "rb") as f:
                instances[raw[:-4]] = pickle.load(f)
    if not instances:
        return []

    # per-instance frame_num -> local index maps (instances may enter the
    # scene at different frames)
    frame_maps = {}
    for ins, data in instances.items():
        T = data["pred"]["poses"]["scale"].shape[0]
        nums_raw = data.get("frame_nums", [])
        nums = [int(np.ravel(n)[0]) for n in nums_raw] \
            if len(nums_raw) else list(range(1, T + 1))
        frame_maps[ins] = {n: i for i, n in enumerate(nums)}
    all_frames = sorted({n for m in frame_maps.values() for n in m})

    suffix = "depth" if depth else "color"
    written = []
    os.makedirs(out_dir, exist_ok=True)
    depth_hi = None  # sequence-constant display scale (no frame flicker)
    for frame_num in all_frames:
        for stem in (f"{frame_num:04d}", str(frame_num)):
            image_path = pjoin(img_dir, scene, f"{stem}_{suffix}.png")
            if os.path.exists(image_path):
                break
        else:
            continue
        if depth:
            raw16 = image_io.read_png(image_path,
                                      unchanged=True).astype(np.float32)
            # a fixed scale from the first frame: a uint8 cast of uint16
            # depth would wrap
            if depth_hi is None:
                depth_hi = max(float(raw16.max()), 1.0)
            img = np.stack([np.clip(raw16 / depth_hi * 255.0, 0, 255)
                            .astype(np.uint8)] * 3, axis=-1)
        else:
            img = image_io.read_png(image_path)[..., ::-1]  # BGR -> RGB
        for ins, data in instances.items():
            if frame_num not in frame_maps[ins]:
                continue
            i = frame_maps[ins][frame_num]
            pred_pose = _pose(data["pred"]["poses"], i)
            corners = data["pred"]["corners"][i]
            if corners is None or not np.isfinite(np.asarray(
                    corners, dtype=np.float32)).all():
                if data.get("gt") is None:  # no GT to fall back on
                    continue
                corners = data["gt"]["corners"]
            boxes = _posed_boxes(pred_pose, corners)
            img = draw_boxes_on_image(img, boxes, intrinsics, color=color)
            if draw_gt and data.get("gt") is not None:
                gt_boxes = _posed_boxes(_pose(data["gt"]["poses"], i),
                                        data["gt"]["corners"])
                img = draw_boxes_on_image(img, gt_boxes, intrinsics,
                                          color=gt_color)
        path = pjoin(out_dir, f"{frame_num}.png")
        image_io.write_png(path, np.ascontiguousarray(img[..., ::-1]))
        written.append(path)
    return written


def visualize_results_dir(results_dir: str, out_dir: str | None = None,
                          max_frames: int = 10):
    """3D box plots of saved trajectories, every T // max_frames-th
    frame: `<out_dir>/<trajectory>_<frame>.png`; returns the paths."""
    _plt()
    out_dir = out_dir or pjoin(results_dir, "vis")
    data_dir = pjoin(results_dir, "data")
    written = []
    for raw in sorted(os.listdir(data_dir)):
        if not raw.endswith(".pkl"):
            continue
        with open(pjoin(data_dir, raw), "rb") as f:
            data = pickle.load(f)
        pred = data["pred"]
        gt = data["gt"]  # None for GT-less captures
        pred_pose = _pose(pred["poses"])
        gt_pose = None if gt is None else _pose(gt["poses"])
        T = pred_pose.scale.shape[0]
        for t in range(0, T, max(1, T // max_frames)):
            boxes = _posed_boxes(pred_pose[t], pred["corners"][t])
            gt_boxes = None if gt_pose is None else _posed_boxes(
                gt_pose[t], gt["corners"])
            path = pjoin(out_dir, f"{raw[:-4]}_{t:03d}.png")
            plot_tracked_boxes_3d(np.zeros((0, 3)), boxes, gt_boxes, path)
            written.append(path)
    return written
