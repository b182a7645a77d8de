"""Frame collation, training batches and trajectory batches (counterpart
of `captra_tpu/data/loader.py`).

Batches are assembled in numpy on the host and returned as CPU tensors
(and a `Pose` of CPU tensors); the tracker and the trainer move them to the
card.  For the same seed, `single_frame_batches` gives the JAX function's
frame order and point shuffle; `prefetch` overlaps the host's reads and
collation with the device's steps; `Mixture` samples several streams by
ratio.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from captra_tpu_torch.pose.part_dof import Pose


def _pose_from_meta(pose_meta) -> dict:
    """meta['pose'] may be a single part dict or a list of per-part dicts
    (reference part_model_batch_to_part, part_dof_utils.py:70-75)."""
    if isinstance(pose_meta, dict):
        pose_meta = [pose_meta]
    rot = np.stack([np.asarray(p["rotation"], np.float32) for p in pose_meta])
    trans = np.stack([np.asarray(p["translation"],
                                 np.float32).reshape(3, 1) for p in pose_meta])
    scale = np.asarray([np.float32(p["scale"]) for p in pose_meta])
    return {"rotation": rot, "translation": trans, "scale": scale}


def _tensor(items, fn) -> torch.Tensor:
    return torch.from_numpy(np.stack([fn(it) for it in items]))


def collate_frames(items: Sequence[dict], shuffle_points: bool = False,
                   rng: np.random.RandomState | None = None) -> dict:
    """List of dataset items -> batched CPU tensors {points[, labels,
    nocs], pose: Pose [B, P], corners [B, P, 2, 3][, depth, mask[,
    det_masks, det_boxes, det_valid]][, crop_translation [B, 1, 3, 1],
    crop_scale [B, 1]]}.

    Each optional key is emitted only when every item carries it: GT-less
    real captures serve bare {points} frames and still collate.
    shuffle_points permutes each frame's points (with its labels and
    nocs) by `rng.permutation`, frame by frame, as the JAX function does;
    it needs `rng`."""
    data = {"points": np.stack([it["data"]["points"] for it in items])}
    for k in ("labels", "nocs"):
        if all(k in it["data"] for it in items):
            data[k] = np.stack([it["data"][k] for it in items])
    if shuffle_points:
        if rng is None:
            raise ValueError("collate_frames(shuffle_points=True) needs rng")
        for b in range(data["points"].shape[0]):
            perm = rng.permutation(data["points"].shape[1])
            for v in data.values():
                v[b] = v[b, perm]
    out = {k: torch.from_numpy(v) for k, v in data.items()}
    metas = [it["meta"] for it in items]
    if all("pose" in m for m in metas):
        poses = [_pose_from_meta(m["pose"]) for m in metas]
        out["pose"] = Pose(*(_tensor(poses, lambda p: p[f])
                             for f in ("rotation", "translation", "scale")))
    if all("nocs_corners" in m for m in metas):
        out["corners"] = _tensor(metas, lambda m: np.asarray(
            m["nocs_corners"], np.float32).reshape(-1, 2, 3))
    if all("pre_fetched" in m for m in metas):
        pre = [m["pre_fetched"] for m in metas]
        out["depth"] = _tensor(pre, lambda p: p["depth"])
        out["mask"] = _tensor(pre, lambda p: p["mask"])
        # NOCS-2D detections for mask-free tracking: fixed-K arrays
        # selected in the step
        if all("det_masks" in p for p in pre):
            for k in ("det_masks", "det_boxes", "det_valid"):
                out[k] = _tensor(pre, lambda p: p[k])
    if all("crop_pose" in m for m in metas):
        # the perturbed crop center / scale that replaces the init pose's
        # t / s for NOCS (reference prepare_poses, model.py:49-58)
        out["crop_translation"] = _tensor(metas, lambda m: np.asarray(
            m["crop_pose"]["translation"], np.float32).reshape(1, 3, 1))
        out["crop_scale"] = _tensor(metas, lambda m: np.float32(
            m["crop_pose"]["scale"]).reshape(1))
    return out


def _stack(values: list):
    """Trajectories [T, ...] -> a batch [T, B, ...]."""
    if isinstance(values[0], Pose):
        return Pose(*(torch.stack([getattr(v, f) for v in values], 1)
                      for f in ("rotation", "translation", "scale")))
    return torch.stack(values, 1)


def sequence_batches(dataset, num_frames: int | None = None,
                     batch_size: int = 1
                     ) -> Iterator[tuple[str | tuple[str, ...], dict]]:
    """Trajectory batches with leading time axis [T, B, ...] (reference
    SequenceData + DataLoader batching, dataset.py:135-205).

    With `num_frames` each track is cut into chunks of that many frames (a
    shorter tail is dropped), else it is one whole track.  Chunks of equal
    length are grouped, in order, into batches of up to `batch_size`; a
    chunk whose collated keys differ from the pending batch's (one track
    lost its pre-fetched depth, say) flushes the pending batch first.
    Yields (name, batch): a plain string when B == 1, a tuple of
    per-trajectory names otherwise."""
    chunks: list[tuple[str, list[int]]] = []
    for name, idxs in dataset.track_index().items():
        cs = ([idxs] if num_frames is None else
              [idxs[i:i + num_frames]
               for i in range(0, len(idxs) - num_frames + 1, num_frames)])
        chunks += [(f"{name}/{ci}", c) for ci, c in enumerate(cs)]

    by_len: dict[int, list[tuple[str, list[int]]]] = {}
    for item in chunks:
        by_len.setdefault(len(item[1]), []).append(item)

    def flush(pending):
        names = tuple(n for n, _ in pending)
        batch = {k: _stack([c[k] for _, c in pending]) for k in pending[0][1]}
        return (names[0] if len(names) == 1 else names), batch

    bs = max(batch_size, 1)
    for group in by_len.values():
        pending: list[tuple[str, dict]] = []
        for name, chunk in group:
            col = collate_frames([dataset[int(i)] for i in chunk])
            if pending and set(col) != set(pending[0][1]):
                yield flush(pending)
                pending = []
            pending.append((name, col))
            if len(pending) == bs:
                yield flush(pending)
                pending = []
        if pending:
            yield flush(pending)


def single_frame_batches(dataset, batch_size: int, shuffle: bool = True,
                         seed: int = 0, drop_last: bool = True,
                         shuffle_points: bool = True,
                         start_batch: int = 0) -> Iterator[dict]:
    """Epoch iterator of collated batches: the frame order shuffled by
    `RandomState(seed)`, each batch's points shuffled by the same stream.
    start_batch skips the first batches without reading them (the same
    order; their point-shuffle draws are not replayed), to fast-forward a
    resumed stream."""
    rng = np.random.RandomState(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for bi, start in enumerate(
            range(0, len(order) - (batch_size - 1 if drop_last else 0),
                  batch_size)):
        idxs = order[start:start + batch_size]
        if len(idxs) < batch_size and drop_last:
            break
        if bi < start_batch:
            continue
        yield collate_frames([dataset[int(i)] for i in idxs],
                             shuffle_points=shuffle_points, rng=rng)


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread buffering: a worker thread runs `iterator` (disk
    reads, collation) while the consumer's steps run, at most `size` items
    ahead.  An error in the worker is raised in the consumer.  If the
    consumer abandons the generator, the worker is told to stop and is not
    left blocked on a full queue holding its items."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=size)
    end = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            err.append(e)
        finally:
            # the end marker must reach a consumer that still reads
            put(end)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


class Mixture:
    """Sample from several iterators with given ratios: `next` gives (key,
    the next item of that iterator), the key drawn by `RandomState(seed)`
    over the sorted keys."""

    def __init__(self, iterators: dict, ratios: dict, seed: int = 0):
        self.iterators = iterators
        keys = sorted(iterators)
        probs = np.asarray([ratios[k] for k in keys], np.float64)
        self.keys = keys
        self.probs = probs / probs.sum()
        self.rng = np.random.RandomState(seed)

    def __next__(self):
        key = self.rng.choice(self.keys, p=self.probs)
        return key, next(self.iterators[key])
