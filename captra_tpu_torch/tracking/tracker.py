"""Frame-recurrent tracking loop (counterpart of
`captra_tpu/tracking/tracker.py`).

One step = canonicalize by the carried root pose -> CoordNet -> per-part
canonicalize -> RotNet -> compose the rotation delta + fit s/t.  The JAX
`lax.scan` becomes a Python loop over frames; frame 0's pose is the given
init and frames[1:] are tracked.

The step is parameterized by two callables (the nets themselves, or test
oracles):
    coord_fn(canon_points [B,N,3]) -> {"seg": [B,N,S], "nocs": [B,N,3P]}
    rot_fn(canon_parts [B,P,N,3], labels [B,N]) -> {"rtvec", "point_rtvec"}

With `nocs_otf` the frames carry raw sensor data instead of points --
depth [B, H, W], mask [B, H, W], optionally the NOCS-2D detections
(`nocs2d_label`) -- and the step backprojects and ball-crops them on the
step's device from the carried pose (`data/preprocess.py`).  The crop's one
random input, a cyclic shift per cloud, comes from frame["shift"] [B] when
the frame carries it, else from the `generator` given to `make_track_step`
(the JAX step draws it from `jax.random`, which torch cannot reproduce).

Every `TrackCfg` option is carried: `refine_iters` / `refine_mode`,
`conf_weighted_delta`, `rot_fit`, `delta_gain`, `scale_clamp`,
`fit_ransac` and `motion_model=const_vel` (whose step carries
(pose, vel_rot, vel_t) and says so with `step.init_carry`).  `fit_ransac`'s
draws are explicit too: frame["gumbel_rot"] (the absolute rotation solve's,
with `rot_fit` != "delta") and frame["gumbel_fit"] (the s/t fit's), each
[B, P, fit_ransac, N], or else drawn from the step's `generator`, once a
frame (the refinement passes reuse them, as the JAX step reuses its frame
key), after the crop's shift.  The JAX step derives them from
`PRNGKey(13)`, folded with frame["key"] when the frame has one
(tracker.py:442-446).

The step opens the tracer's spans (`utils/profiling.annotate`, recorded
only while a profiler runs): `track.step` around it, and inside it
`track.crop` (OTF), then a pass's `track.coordnet`, `track.rotnet` and
`track.fit` around the nets' calls and the pose fit.

On CUDA the step replays its body as one CUDA graph once it has seen a
call's signature twice (`make_track_step` gives the rule), so a step costs
the host a few copies and one graph launch instead of a few hundred kernel
launches.  `graph_counts` counts the calls by path.

Frame 0: `init_pose_from_gt` (noise draws explicit, as in
`pose.part_dof.add_noise_to_pose`), or for GT-less captures
`init_pose_from_cloud` and the orientation search
`search_init_orientation`.  Line references (tracker.py:N) are to the JAX
package's `captra_tpu/tracking/tracker.py`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled

from captra_tpu_torch.config.schema import Config, TrackCfg
from captra_tpu_torch.data.preprocess import (
    NOCS_REAL_INTRINSICS, backproject_depth_planes, crop_ball_batch_planes,
    intrinsics_tensor, select_detection_mask, unpack_detection_masks,
)
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.models.coordnet import canonicalize
from captra_tpu_torch.models.rotnet import (
    canonicalize_per_part, compose_track_pose, decode_rotation,
)
from captra_tpu_torch.ops import fps, neighbors, pointops, sa_mlp
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.pose.part_dof import (
    Pose, add_noise_to_pose, eval_part_full, tree_root,
)
from captra_tpu_torch.pose.pose_fit import filter_valid, labels_to_part_mask
from captra_tpu_torch.pose.procrustes import gumbel_or_draw, similarity_fit
from captra_tpu_torch.utils.precision import f32_precision
from captra_tpu_torch.utils.profiling import SyncCount, annotate

# the calls of every step `make_track_step` built, by path: run eagerly,
# captured into a CUDA graph (the call's answer is the capture's eager
# warm-up), replayed from one
graph_counts = {"eager": 0, "captured": 0, "replayed": 0}

# the kernel wrappers' launch counters: a capture records how much each grew
# and every replay adds that again, so a replayed step counts its launches
_LAUNCH_COUNTERS = (fps.launch_counts, sa_mlp.launch_counts,
                    neighbors.launch_counts)


@dataclass
class TrackAux:
    """Per-frame outputs, stacked over tracked frames by
    `track_trajectory`."""
    pose: Pose                  # [B, P] fitted pose
    pred_labels: torch.Tensor   # [B, N]
    seg: torch.Tensor           # [B, N, S]
    nocs: torch.Tensor          # [B, N, 3P]


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _maybe_on(x, device: torch.device):
    return None if x is None else _on(x, device)


def _where_pose(cond: torch.Tensor, new: Pose, old: Pose) -> Pose:
    """Per leading index of `cond` ([B] or [B, P]): `new` where true, else
    `old`."""
    def sel(n, o):
        return torch.where(cond.reshape(cond.shape + (1,) * (
            n.dim() - cond.dim())), n, o)
    return Pose(sel(new.rotation, old.rotation),
                sel(new.translation, old.translation),
                sel(new.scale, old.scale))


def eager_reason(device: torch.device, track: TrackCfg,
                 frame: dict) -> str | None:
    """Why a step call on `device` with `frame` runs eagerly, or None where
    it may replay a CUDA graph.  A replay makes no Python call, so it runs
    eagerly off CUDA, while a profiler records (the tracer's spans and
    counters, and hooks on the step's calls, need them), while the point
    ops' FPS entry is wrapped (a recorder, or the plain FPS swapped in),
    where the frame needs a draw from the step's generator (an OTF frame
    without "shift", RANSAC draws the frame does not carry), and where a
    frame entry is not an array."""
    if device.type != "cuda":
        return "not a CUDA step"
    if _profiler_enabled():
        return "a profiler records"
    if pointops.farthest_point_sample_indices \
            is not fps.farthest_point_sample_indices:
        return "the FPS entry is wrapped"
    if track.nocs_otf and frame.get("shift") is None:
        return "the crop draws its shifts"
    if track.fit_ransac > 0 and (
            frame.get("gumbel_fit") is None
            or (track.rot_fit != "delta" and frame.get("gumbel_rot") is None)):
        return "the fit draws its RANSAC hypotheses"
    if not all(isinstance(v, (torch.Tensor, np.ndarray))
               for v in frame.values()):
        return "a frame entry is not an array"
    return None


def _tree_map(fn, tree):
    """`tree` (tensors in tuples, dicts and dataclasses such as `Pose` and
    `TrackAux`) with `fn` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _span(x: torch.Tensor) -> torch.Tensor:
    """The storage `x` covers, from its first element to its last, as one
    flat view."""
    n = 1 + sum((s - 1) * st for s, st in zip(x.shape, x.stride())) \
        if x.numel() else 0
    return x.as_strided((n,), (1,), x.storage_offset())


def _buffer_like(x: torch.Tensor, device) -> torch.Tensor:
    """A new tensor on `device` with the shape and strides of `x` (a
    kernel may round otherwise on another layout)."""
    base = torch.empty(_span(x).shape, dtype=x.dtype, device=device)
    return base.as_strided(x.shape, x.stride())


def _fresh(tree):
    """Copies of the tensors of `tree`, each laid out as its original; a
    tensor met twice (the pose in the aux) is copied once."""
    copies = {}

    def copy(x):
        if id(x) not in copies:
            copies[id(x)] = _span(x).clone().as_strided(x.shape, x.stride())
        return copies[id(x)]
    return _tree_map(copy, tree)


def _layout(x: torch.Tensor) -> tuple:
    return tuple(x.shape), x.stride(), x.dtype, x.device


def _signature(carry, frame: dict) -> tuple:
    """What a captured step is valid for: the layout of every carry and
    frame tensor, the frame's keys, and the switches that choose kernels
    (TF32, autocast, deterministic algorithms, the blocked FPS opt-in)."""
    return (tuple(_layout(x) for x in _leaves(carry)),
            tuple(sorted((k, _layout(v)) for k, v in frame.items())),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"),
            torch.are_deterministic_algorithms_enabled(), fps.use_blocked())


class _Graph:
    """One captured step: its input buffers, its outputs and the launch
    counts one step adds."""

    def __init__(self, carry, frame: dict, device):
        self.graph = torch.cuda.CUDAGraph()
        self.carry = _tree_map(lambda x: _buffer_like(x, x.device), carry)
        self.frame = {k: _buffer_like(v, device) for k, v in frame.items()}
        self.out = None
        self.growth = None

    def load(self, carry, frame: dict) -> None:
        """Copy a call's carry and frame into the input buffers."""
        for buf, x in zip(_leaves(self.carry), _leaves(carry)):
            _span(buf).copy_(_span(x))
        for k, buf in self.frame.items():
            _span(buf).copy_(_span(frame[k]))

    def replay(self, carry, frame: dict):
        self.load(carry, frame)
        self.graph.replay()
        for counts, grown in zip(_LAUNCH_COUNTERS, self.growth):
            for k, n in grown.items():
                counts[k] += n
        graph_counts["replayed"] += 1
        return _fresh(self.out)


_SEEN, _EAGER = "seen", "eager"


class _StepGraphs:
    """The step's path by call signature: eager the first time, captured
    the second, replayed after (see `make_track_step`)."""

    def __init__(self, body: Callable, device: torch.device,
                 track: TrackCfg):
        self.body = body
        self.device = device
        self.track = track
        self.graphs = {}      # signature -> _SEEN, _EAGER or a _Graph
        self.stream = None

    @torch.no_grad()
    def __call__(self, carry, frame: dict):
        if eager_reason(self.device, self.track, frame) is None:
            arrays = {k: torch.as_tensor(v) for k, v in frame.items()}
            sig = _signature(carry, arrays)
            entry = self.graphs.get(sig)
            if isinstance(entry, _Graph):
                return entry.replay(carry, arrays)
            if entry == _SEEN:
                return self.capture(sig, carry, arrays)
            if entry is None:
                self.graphs[sig] = _SEEN
        graph_counts["eager"] += 1
        return self.body(carry, frame)

    def capture(self, sig, carry, frame: dict):
        """torch's pattern: a warm-up on a side stream (whose answer this
        call returns), then the capture on it.  A body that synchronises
        the host in its warm-up cannot be captured and stays eager."""
        graph = _Graph(carry, frame, self.device)
        graph.load(carry, frame)
        main = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            syncs = SyncCount()
            try:
                out = self.body(graph.carry, graph.frame)
            finally:
                synced = syncs.close()
        main.wait_stream(self.stream)
        result = _fresh(out)
        del out
        if synced:
            self.graphs[sig] = _EAGER
            graph_counts["eager"] += 1
            return result
        before = [dict(counts) for counts in _LAUNCH_COUNTERS]
        with torch.cuda.graph(graph.graph, stream=self.stream):
            graph.out = self.body(graph.carry, graph.frame)
        # the capture launched nothing: its counts move to every replay
        graph.growth = []
        for counts, was in zip(_LAUNCH_COUNTERS, before):
            graph.growth.append({k: counts[k] - was[k] for k in counts})
            counts.update(was)
        self.graphs[sig] = graph
        graph_counts["captured"] += 1
        return result


def make_track_step(cfg: Config, coord_fn: Callable, rot_fn: Callable,
                    device=None, intrinsics=None,
                    generator: torch.Generator | None = None):
    """Build the step: (pose [B, P], frame dict) -> (new pose, TrackAux).

    A frame carries points [B, N, 3] (raw camera) and optional labels
    [B, N]; with `cfg.track.nocs_otf` it carries depth [B, H, W] (integer
    mm) and mask [B, H, W] instead, plus optional "shift" [B] (the crop's
    cyclic shifts, in [0, H*W)) and, for `nocs2d_label`, det_masks
    [B, K, H, ceil(W/8)] uint8 (bit-packed), det_boxes [B, K, 4] and
    det_valid [B, K].  Frame arrays are moved to `device` (CUDA unless
    given).  `intrinsics` [3, 3] defaults to the NOCS real camera;
    `generator` (on `device`) draws the shifts and the RANSAC draws of
    frames that carry none.  With `motion_model=const_vel` the step's carry
    is (pose, vel_rot, vel_t) and `step.init_carry(pose)` makes the first
    one.

    On CUDA the step replays its body as one CUDA graph.  A call's
    signature is the layout (shape, strides, dtype, device) of every carry
    and frame tensor, the frame's keys, and the switches that choose
    kernels: TF32, autocast, deterministic algorithms, the blocked FPS
    opt-in.  The first call with a signature runs eagerly (kernel builds
    and lazy set-up happen there); the second runs the body on a side
    stream, returns that answer and captures the body; every later call
    copies the carry and frame into the graph's input buffers, replays it
    and returns fresh copies of its outputs, which the caller may keep.
    Each signature's graph is kept.  A call runs eagerly where
    `eager_reason` gives a reason: off CUDA, while a profiler records,
    while the FPS entry is wrapped, where the frame needs a draw from
    `generator` (an OTF frame without "shift", or `fit_ransac > 0` without
    the frame's draws), or where a frame entry is not an array; so does a
    signature whose body synchronises the host.  A replay reads the nets'
    parameters and buffers from the storage they had at capture, and takes
    the nets' Python-side choices (train or eval mode) of the capture:
    in-place updates (an optimizer's step, `load_state_dict`, BatchNorm's
    running statistics) are followed, a parameter given new storage
    (`p.data = ...`) or a net switched to another mode is not, so build a
    new step after either."""
    device = resolve_device(device)
    obj = cfg.obj
    root = tree_root(obj.tree)
    P = obj.num_parts
    track = cfg.track
    # only the OTF crop reads the camera (a copy from host memory, which
    # synchronises the host, once a step built)
    K = intrinsics_tensor(NOCS_REAL_INTRINSICS if intrinsics is None
                          else intrinsics, device) if track.nocs_otf else None

    def otf_points(pose: Pose, frame: dict):
        """Raw depth -> cropped points [B, N, 3], mask labels [B, N] and
        frame_ok [B] (tracker.py:366-429)."""
        depth = _on(frame["depth"], device)
        B = depth.shape[0]
        image_hw = tuple(depth.shape[-2:])
        center = pose.translation[:, root, :, 0]              # [B, 3]
        radius = cfg.data_radius * pose.scale[:, root]        # [B]
        if "shift" in frame:
            shift = _on(frame["shift"], device)
        elif generator is not None:
            shift = torch.randint(0, image_hw[0] * image_hw[1], (B,),
                                  generator=generator, device=device)
        else:
            raise ValueError("an OTF frame needs frame['shift'] or a "
                             "generator given to make_track_step")

        if track.nocs2d_label and "det_masks" in frame:
            # mask-free tracking: select the detection in the step; a frame
            # with no valid detection keeps its instance mask, or, with
            # none, labels every cropped point object (tracker.py:381-413).
            # The selection indexes the packed masks, and only the chosen
            # one is unpacked.
            packed, found = select_detection_mask(
                _on(frame["det_masks"], device),
                _on(frame["det_boxes"], device),
                _on(frame["det_valid"], device), center, radius, K,
                image_hw)
            picked = unpack_detection_masks(packed, image_hw)
            prior = (_on(frame["mask"], device).bool() if "mask" in frame
                     else torch.ones_like(picked))
            masks = torch.where(found[:, None, None], picked, prior)
        else:
            masks = _on(frame["mask"], device)

        pts3, valid = backproject_depth_planes(depth, K)
        points3, idx = crop_ball_batch_planes(
            shift, pts3, valid, center, radius, cfg.num_points,
            work_factor=track.otf_work_factor, fps_mode=track.otf_fps_mode)
        labels = 1 - torch.gather(masks.reshape(B, -1), 1, idx).long()
        # total sensor dropout: the step freezes the carried pose
        frame_ok = valid.any(-1)
        return points3.transpose(1, 2), labels, frame_ok

    def ransac_draws(frame: dict, B: int, N: int):
        """The frame's RANSAC draws (gumbel_rot, gumbel_fit), else drawn
        from the generator, rot first (tracker.py:442-446)."""
        if track.fit_ransac <= 0:
            return None, None
        shape = (B, P, track.fit_ransac, N)
        g_rot = None
        if track.rot_fit != "delta":
            g_rot = gumbel_or_draw(_maybe_on(frame.get("gumbel_rot"), device),
                                   shape, generator, "track_cfg/fit_ransac")
        g_fit = gumbel_or_draw(_maybe_on(frame.get("gumbel_fit"), device),
                               shape, generator, "track_cfg/fit_ransac")
        return g_rot, g_fit

    def predict_compose(pose: Pose, points, points_mean, frame_labels,
                        draws, invert_delta: bool = False):
        """One {canonicalize -> CoordNet -> RotNet -> compose + fit} pass
        from `pose` (tracker.py:431-525); with invert_delta the transposed
        delta is composed (the debias refinement)."""
        # CoordNet in the root part's previous frame
        root_pose = Pose(rotation=pose.rotation[:, root],
                         translation=pose.translation[:, root],
                         scale=pose.scale[:, root])
        canon = canonicalize(points, points_mean, root_pose)
        with annotate("track.coordnet"):
            coord_out = coord_fn(canon)
        seg, nocs = coord_out["seg"], coord_out["nocs"]
        pred_labels = torch.argmax(seg, dim=-1)              # [B, N]
        # gt_label / nocs2d_label: the frame's mask-derived labels drive the
        # s/t fit (tracker.py:460-464)
        if (track.gt_label or track.nocs2d_label) \
                and frame_labels is not None:
            labels = frame_labels
        else:
            labels = pred_labels

        # RotNet in each part's previous frame
        canon_parts = canonicalize_per_part(points, points_mean, pose)
        with annotate("track.rotnet"):
            rot_out = rot_fn(canon_parts, labels)
        # rotation decode, composition, the s/t fit and validity
        with annotate("track.fit"):
            if track.conf_weighted_delta:
                # the per-point reps weighted by each point's seg confidence
                # for its label; a part of zero total weight keeps the net's
                # rtvec
                prob = torch.gather(seg, -1, labels[..., None])[..., 0]
                w = labels_to_part_mask(labels, P) * prob[:, None]  # [B,P,N]
                w_sum = torch.sum(w, dim=-1, keepdim=True)
                rt = torch.sum(rot_out["point_rtvec"] * w[..., None],
                               dim=-2) / torch.clamp(w_sum, min=1e-6)
                rot_out = dict(rot_out, rtvec=torch.where(
                    w_sum > 0, rt, rot_out["rtvec"]))
            delta, _ = decode_rotation(rot_out, obj.sym)
            if invert_delta:
                delta = delta.transpose(-1, -2)

            B, N = labels.shape
            pred_npcs = nocs.reshape(B, N, P, 3).movedim(2, 1)  # [B,P,N,3]
            new_pose = compose_track_pose(
                pose, delta, labels, pred_npcs, points, points_mean,
                num_parts=P, sym=obj.sym, scale_clamp=track.scale_clamp,
                rot_fit=track.rot_fit, rot_fit_alpha=track.rot_fit_alpha,
                delta_gain=track.delta_gain, fit_ransac=track.fit_ransac,
                fit_ransac_th=track.fit_ransac_th, gumbel_rot=draws[0],
                gumbel_fit=draws[1])
        return new_pose, TrackAux(pose=new_pose, pred_labels=pred_labels,
                                  seg=seg, nocs=nocs)

    @torch.no_grad()
    def step(pose: Pose, frame: dict):
        with annotate("track.step"):
            frame_ok = None
            frame_labels = _maybe_on(frame.get("labels"), device)
            if track.nocs_otf:
                with annotate("track.crop"):
                    points_raw, frame_labels, frame_ok = otf_points(pose,
                                                                    frame)
            else:
                points_raw = _on(frame["points"], device)
            points_mean = torch.mean(points_raw, dim=1)          # [B, 3]
            points = points_raw - points_mean[:, None]
            B, N = points.shape[:2]
            draws = ransac_draws(frame, B, N)

            new_pose, aux = predict_compose(pose, points, points_mean,
                                            frame_labels, draws)
            # refinement passes from the just-fitted pose: "forward" composes
            # the new delta, "debias" its inverse (tracker.py:519-534)
            for _ in range(max(track.refine_iters, 1) - 1):
                new_pose, aux = predict_compose(
                    new_pose, points, points_mean, frame_labels, draws,
                    invert_delta=track.refine_mode == "debias")
            if frame_ok is not None:
                # a frame with no valid depth carries the previous pose
                # through (tracker.py:535-545)
                new_pose = _where_pose(frame_ok, new_pose, pose)
                aux = TrackAux(pose=new_pose, pred_labels=aux.pred_labels,
                               seg=aux.seg, nocs=aux.nocs)
            return new_pose, aux

    if track.motion_model != "const_vel":
        return _StepGraphs(step, device, track)

    # carry (pose, vel_rot [B,P,3,3], vel_t [B,P,3,1]): the nets see the pose
    # advanced by gain x the low-passed world-frame velocity, the fitted pose
    # is carried, and the velocity moves toward the observed delta by beta;
    # frame 0 starts at zero velocity (tracker.py:547-584)
    gain, beta = track.motion_gain, track.motion_beta

    @torch.no_grad()
    def step_cv(carry, frame: dict):
        pose, vel_rot, vel_t = carry
        pose_pred = Pose(rotation=_mm(_scale_rot(vel_rot, gain),
                                      pose.rotation),
                         translation=pose.translation + gain * vel_t,
                         scale=pose.scale)
        new_pose, aux = step(pose_pred, frame)
        obs_rot = _mm(new_pose.rotation, pose.rotation.transpose(-1, -2))
        # geodesic low-pass: v' = exp(beta * log(obs v^-1)) v
        new_vel_rot = _mm(_scale_rot(_mm(obs_rot, vel_rot.transpose(-1, -2)),
                                     beta), vel_rot)
        new_vel_t = vel_t + beta * (
            (new_pose.translation - pose.translation) - vel_t)
        return (new_pose, new_vel_rot, new_vel_t), aux

    def init_carry(init_pose: Pose):
        return (init_pose,
                torch.eye(3, dtype=init_pose.rotation.dtype,
                          device=init_pose.rotation.device).expand(
                    init_pose.rotation.shape),
                torch.zeros_like(init_pose.translation))

    graphed = _StepGraphs(step_cv, device, track)
    graphed.init_carry = init_carry
    return graphed


@f32_precision
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-float32 matmul for the motion model's pose algebra (the JAX
    step asks for HIGHEST precision there)."""
    return a @ b


def _scale_rot(m: torch.Tensor, factor) -> torch.Tensor:
    """exp(factor * log(m)) for rotation matrices (angle scaling)."""
    axis, theta = rot.matrix_to_axis_theta(m)
    return rot.axis_theta_to_matrix(axis, factor * theta)


def extrapolate_pose(prev: Pose, cur: Pose, gain: float = 1.0) -> Pose:
    """Constant-velocity prediction from two consecutive poses: `cur`
    advanced by the world-frame delta from `prev` to `cur`, scaled by
    `gain` (scale held; gain 0 is the identity).  The tracking step carries
    a low-passed velocity instead (the raw double difference is marginally
    unstable in closed loop); this is the one-shot predictor."""
    d_rot = _mm(cur.rotation, prev.rotation.transpose(-1, -2))
    if gain != 1.0:
        d_rot = _scale_rot(d_rot, gain)
    return Pose(rotation=_mm(d_rot, cur.rotation),
                translation=cur.translation
                + gain * (cur.translation - prev.translation),
                scale=cur.scale)


def track_trajectory(step: Callable, init_pose: Pose, frames: dict,
                     device=None):
    """Run the step over frames with leading time axis [T, B, ...].

    Frame 0's pose is the given init (the reference skips inference on
    frame 0 too); frames[1:] are tracked.  A step with `init_carry` (the
    motion model) starts from `step.init_carry(init_pose)`.  Returns (final
    pose, TrackAux stacked over the T-1 tracked frames)."""
    device = resolve_device(device)
    frames = {k: _on(v, device) for k, v in frames.items()}
    carry = init_pose.map(lambda x: _on(x, device))
    make_carry = getattr(step, "init_carry", None)
    if make_carry is not None:
        carry = make_carry(carry)
    T = next(iter(frames.values())).shape[0]
    auxs = []
    for t in range(1, T):
        carry, aux = step(carry, {k: v[t] for k, v in frames.items()})
        auxs.append(aux)
    pose = carry[0] if make_carry is not None else carry
    return pose, TrackAux(
        pose=Pose(*(torch.stack([getattr(a.pose, f) for a in auxs])
                    for f in ("rotation", "translation", "scale"))),
        pred_labels=torch.stack([a.pred_labels for a in auxs]),
        seg=torch.stack([a.seg for a in auxs]),
        nocs=torch.stack([a.nocs for a in auxs]))


def evaluate_track(pred_poses: Pose, gt_poses: Pose, sym: bool) -> dict:
    """Per-frame errors for stacked poses [T, B, P] (`eval_part_full`; only
    the y axis counts for symmetric categories)."""
    return eval_part_full(gt_poses, pred_poses, yaxis_only=sym)


# ---------------------------------------------------------------------------
# frame-0 initialisation
# ---------------------------------------------------------------------------

def _deg2rad_f32(deg: float) -> float:
    """`jnp.deg2rad` of a Python float: float32(deg) * float32(pi / 180),
    rounded to float32."""
    return float(np.float32(deg) * np.float32(np.pi / 180))


def init_pose_from_gt(gt_pose: Pose, cfg: Config, noise: dict | None = None,
                      generator: torch.Generator | None = None,
                      crop_translation: torch.Tensor | None = None,
                      crop_scale: torch.Tensor | None = None) -> Pose:
    """Frame-0 pose (tracker.py:42-61): the GT with `init_frame/gt`, else
    the GT perturbed by `cfg.perturb` (`add_noise_to_pose`, its draws
    `noise` or from `generator`); a given crop pose's t and s then replace
    the noisy ones.  Runs on `gt_pose`'s device."""
    if cfg.track.init_frame_gt:
        return gt_pose
    pose = add_noise_to_pose(gt_pose, rot_rad=_deg2rad_f32(cfg.perturb.r),
                             trans_sigma=cfg.perturb.t,
                             scale_sigma=cfg.perturb.s,
                             kind=cfg.perturb.kind, noise=noise,
                             generator=generator)
    if crop_translation is not None:
        pose = Pose(rotation=pose.rotation,
                    translation=torch.as_tensor(crop_translation).to(
                        pose.translation).expand(pose.translation.shape),
                    scale=torch.as_tensor(crop_scale).to(pose.scale).expand(
                        pose.scale.shape))
    return pose


def init_pose_from_cloud(points, num_parts: int, data_radius: float = 0.6,
                         device=None) -> Pose:
    """Frame-0 init for GT-less captures (tracker.py:64-81): identity
    rotation, the cloud's mean as center, and the scale at which the crop
    ball (data_radius x scale) covers the cloud, for every part.
    points: [B, N, 3] camera cloud of frame 0, moved to `device` (CUDA
    unless given)."""
    device = resolve_device(device)
    points = _on(points, device)
    B = points.shape[0]
    center = torch.mean(points, dim=1)                       # [B, 3]
    r = torch.amax(torch.linalg.norm(points - center[:, None], dim=-1),
                   dim=1)
    scale = r / torch.tensor(data_radius, dtype=r.dtype, device=device)
    return Pose(
        rotation=torch.eye(3, device=device).expand(B, num_parts, 3, 3),
        translation=center[:, None, :, None].expand(B, num_parts, 3, 1),
        scale=scale[:, None].expand(B, num_parts))


def _super_fibonacci_quats(n: int) -> np.ndarray:
    """n unit quaternions covering SO(3) near-uniformly (the super-Fibonacci
    spiral, Alexa CVPR 2022), float32."""
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, big_r = np.sqrt(t), np.sqrt(1.0 - t)
    alpha = d / np.sqrt(2.0)
    beta = d / 1.533751168755204288118041  # psi: x^4 = x + 4
    q = np.stack([r * np.sin(alpha), r * np.cos(alpha),
                  big_r * np.sin(beta), big_r * np.cos(beta)], axis=-1)
    return q.astype(np.float32)


def _fibonacci_sphere(n: int) -> np.ndarray:
    """n unit vectors covering S^2 (golden-angle spiral), float64."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    return np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1)


def _rots_y_to(dirs: np.ndarray) -> np.ndarray:
    """Minimal rotations taking +y to each unit vector of `dirs` [K, 3]
    (Rodrigues), float32."""
    ey = np.array([0.0, 1.0, 0.0])
    c = dirs @ ey
    axis = np.cross(np.broadcast_to(ey, dirs.shape), dirs)
    s = np.linalg.norm(axis, axis=-1)
    # near +-y the axis is ill-defined; any orthogonal axis works
    axis = np.where(s[:, None] > 1e-8, axis / np.maximum(s, 1e-8)[:, None],
                    np.array([1.0, 0.0, 0.0]))
    K = np.zeros(dirs.shape[:-1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + s[:, None, None] * K + ((1.0 - c))[:, None, None] * (K @ K)
    return R.astype(np.float32)


def init_candidates(K: int, sym: bool) -> torch.Tensor:
    """The search's K candidate rotations [K, 3, 3] on the CPU: identity
    first, then for a symmetric category the minimal rotations to K - 1
    Fibonacci y-axis directions, else K - 1 super-Fibonacci rotations."""
    cand = torch.eye(3)[None]
    if K > 1:
        extra = (torch.from_numpy(_rots_y_to(_fibonacci_sphere(K - 1)))
                 if sym else rot.quat_to_matrix(
                     torch.from_numpy(_super_fibonacci_quats(K - 1))))
        cand = torch.cat([cand, extra], 0)
    return cand


# the search's CoordNet batch: at most this many clouds a forward
INIT_SEARCH_CHUNK = 128


@torch.no_grad()
def search_init_orientation(coord_fn: Callable, points, init_pose: Pose,
                            cfg: Config, device=None) -> Pose:
    """Frame-0 coarse orientation search for GT-less init
    (tracker.py:133-315).

    K = `track_cfg/init_search` candidates (`init_candidates`, composed
    onto `init_pose`'s rotation), each descended by `init_search_steps`
    passes of {canonicalize -> CoordNet -> absolute NPCS similarity fit},
    the candidates run through CoordNet in chunks of at most
    `INIT_SEARCH_CHUNK` clouds (a Python loop over the chunks, the last
    padded with copies of candidate 0).  Selection: `init_search_scorer`
    "basin" takes the highest basin logit of the undescended candidates;
    "mode" with `init_search_tau` > 0 the densest mode of the descended
    root rotations within tau degrees (y axes for a symmetric category),
    the least fit residual inside it; tau <= 0 the least residual.  Ties go
    to the first candidate, as the JAX argmax / argmin break them.  A
    trajectory whose every candidate is degenerate keeps `init_pose`.

    points: [B, N, 3] camera cloud of frame 0; init_pose: [B, P] guess
    (typically `init_pose_from_cloud`'s); both moved to `device` (CUDA
    unless given).  Returns the chosen descended pose [B, P]."""
    device = resolve_device(device)
    points = _on(points, device)
    init_pose = init_pose.map(lambda x: _on(x, device))
    obj = cfg.obj
    K = int(cfg.track.init_search)
    use_basin = str(cfg.track.init_search_scorer) == "basin"
    root = tree_root(obj.tree)
    B, N, _ = points.shape
    P = obj.num_parts

    cand = init_candidates(K, obj.sym).to(device)
    KC = max(1, min(K, -(-INIT_SEARCH_CHUNK // B)))
    G = -(-K // KC)
    Kp = G * KC
    if Kp != K:  # pad with copies of candidate 0 (never better than it)
        cand = torch.cat([cand, cand[:1].expand(Kp - K, 3, 3)], 0)

    rot_all = torch.einsum("kij,bpjl->kbpil", cand, init_pose.rotation)
    points_mean = torch.mean(points, dim=1)                 # [B, 3]
    centered = points - points_mean[:, None]                # [B, N, 3]
    steps = max(int(cfg.track.init_search_steps), 1)
    M = KC * B
    ctr = centered[None].expand(KC, B, N, 3).reshape(M, N, 3)
    mean = points_mean[None].expand(KC, B, 3).reshape(M, 3)
    cam = ctr[:, None] + mean[:, None, None]                # [M, 1, N, 3]

    poses, scores = [], []
    for g in range(G):
        pose = Pose(
            rotation=rot_all[g * KC:(g + 1) * KC].reshape(M, P, 3, 3),
            translation=init_pose.translation[None].expand(
                KC, B, P, 3, 1).reshape(M, P, 3, 1),
            scale=init_pose.scale[None].expand(KC, B, P).reshape(M, P))
        for si in range(steps):
            root_pose = Pose(rotation=pose.rotation[:, root],
                             translation=pose.translation[:, root],
                             scale=pose.scale[:, root])
            out = coord_fn(canonicalize(ctr, mean, root_pose))
            if si == 0 and use_basin:
                if "basin" not in out:
                    raise ValueError(
                        "track_cfg/init_search_scorer=basin needs a "
                        "CoordNet with network/basin_head=True")
                # scored on the undescended canonicalization
                basin0 = out["basin"].float()
            labels = torch.argmax(out["seg"], dim=-1)       # [M, N]
            pred_npcs = out["nocs"].reshape(M, N, P, 3).movedim(2, 1)
            mask = labels_to_part_mask(labels, P)           # [M, P, N]
            r_fit, s_fit, t_fit = similarity_fit(pred_npcs, cam, mask,
                                                 sym=obj.sym)
            fitted = Pose(rotation=r_fit, translation=t_fit, scale=s_fit)
            valid = filter_valid(fitted, torch.sum(mask, -1) > 3,
                                 min_scale=1e-4)            # [M, P]
            pose = _where_pose(valid, fitted, pose)
            # the camera-space residual of this pass's fit over the valid
            # parts; a candidate with no valid part sinks
            posed = s_fit[..., None, None] * (
                pred_npcs @ r_fit.transpose(-1, -2)) \
                + t_fit.transpose(-1, -2)
            resid = torch.sum((posed - cam) ** 2, dim=-1)   # [M, P, N]
            w = mask * valid[..., None].to(mask.dtype)
            tot = torch.sum(w, dim=(-1, -2))
            score = torch.sum(resid * w, dim=(-1, -2)) / torch.clamp(tot,
                                                                     min=1.)
            score = torch.where(tot > 3, score, torch.inf)
        if use_basin:
            score = -basin0          # lower is better, as the residual
        poses.append(pose.map(lambda x: x.reshape((KC, B) + x.shape[1:])))
        scores.append(score.reshape(KC, B))
    poses = Pose(*(torch.cat([getattr(p, f) for p in poses])
                   for f in ("rotation", "translation", "scale")))
    scores = torch.cat(scores).T                            # [B, Kp]

    tau = float(cfg.track.init_search_tau)
    if use_basin or tau <= 0.0:
        best = torch.argmin(scores, dim=1)                  # [B]
    else:
        # densest mode of the descended root rotations, least residual in it
        rroot = poses.rotation[:, :, root]                  # [Kp, B, 3, 3]
        if obj.sym:
            ax = rroot[..., :, 1]                           # [Kp, B, 3]
            cosang = torch.einsum("kbi,lbi->bkl", ax, ax)
        else:
            tr = torch.einsum("kbij,lbij->bkl", rroot, rroot)
            cosang = (tr - 1.0) * 0.5
        cos_tau = float(np.cos(np.float32(_deg2rad_f32(tau))))
        finite = torch.isfinite(scores)                     # [B, Kp]
        near = (cosang >= cos_tau) & finite[:, None, :] & finite[:, :, None]
        count = torch.where(finite, torch.sum(near, dim=-1), -1)
        in_mode = count == torch.amax(count, dim=1, keepdim=True)
        best = torch.argmin(torch.where(in_mode, scores, torch.inf), dim=1)

    chosen = poses[best, torch.arange(B, device=device)]
    # every candidate degenerate (e.g. an empty cloud): keep the guess
    ok = torch.isfinite(torch.amin(scores, dim=1))
    return _where_pose(ok, chosen, init_pose)
