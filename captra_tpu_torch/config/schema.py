"""Typed experiment configuration (the port's own copy of
`captra_tpu/config/schema.py`; the port imports nothing from `captra_tpu`).

Mirrors the reference's 3-level YAML config (experiment / object / pointnet)
as frozen dataclasses: hashable, and every derived field (`num_parts`,
`tree`, `sym`, ...) is resolved once at load time.  Field comments that cite
measurements describe the JAX package's experiments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping


@dataclass(frozen=True)
class SAMsgCfg:
    """One multi-scale-grouping set-abstraction stage
    (reference pointnet2_camera.yml sa1/sa2)."""
    npoint: int
    radius_list: tuple[float, ...]
    nsample_list: tuple[int, ...]
    mlp_list: tuple[tuple[int, ...], ...]


@dataclass(frozen=True)
class PointNetCfg:
    """PointNet++ MSG hyperparameters (reference
    configs/pointnet_config/pointnet2_camera.yml)."""
    sa1: SAMsgCfg = SAMsgCfg(
        npoint=512,
        radius_list=(0.05, 0.1, 0.2),
        nsample_list=(32, 64, 128),
        mlp_list=((32, 32, 64), (64, 64, 128), (64, 96, 128)),
    )
    sa2: SAMsgCfg = SAMsgCfg(
        npoint=128,
        radius_list=(0.2, 0.4),
        nsample_list=(64, 128),
        mlp_list=((128, 128, 256), (128, 196, 256)),
    )
    sa3_mlp: tuple[int, ...] = (256, 512, 1024)
    fp3_mlp: tuple[int, ...] = (256, 256)
    fp2_mlp: tuple[int, ...] = (256, 128)
    fp1_mlp: tuple[int, ...] = (128, 128)


@dataclass(frozen=True)
class ObjCfg:
    """Object-category config (reference configs/obj_config/*.yml)."""
    category: str = "laptop"
    name: str = "laptop"
    num_parts: int = 2
    num_joints: int = 1
    tree: tuple[int, ...] = (-1, 0)
    sym: bool = False
    joint_type: str = "revolute"          # revolute | prismatic
    main_axis: tuple[int, ...] = (0,)
    extra_dims: int = 0                   # 1 for NOCS (background channel)
    num_frames: int = 100
    synthetic: bool = True
    nocs_data: bool = False
    bad_ins: tuple[str, ...] = ()
    # train split = complement of test_list (the reference's `train_list:`
    # YAML key is always empty and never read — split_dataset derives
    # train_ins by exclusion, data_utils.py:28-40; no train_list field here
    # so split selection cannot silently diverge from that rule)
    test_list: tuple[str, ...] = ()
    basepath: str = ""

    @property
    def root(self) -> int:
        return [i for i, p in enumerate(self.tree) if p == -1][0]

    @property
    def num_seg(self) -> int:
        return self.num_parts + self.extra_dims


@dataclass(frozen=True)
class NetworkCfg:
    """Network options (reference config_*.yml `network:` block)."""
    type: str = "rot_coord_track"  # canon_coord | rot | rot_coord_track
    backbone_out_dim: int = 128
    nocs_head_dims: tuple[int, ...] = (128,)
    pwm_num: int = 128
    # MXU compute dtype for the backbone/heads ("bfloat16" on TPU for ~2x
    # bandwidth; pose math stays float32 regardless)
    compute_dtype: str = "float32"
    # backbone SA-layer centroid sampling: "exact" | "grouped" (stratified
    # approximation, latency win at batch 1; train/test must match)
    fps_mode: str = "exact"
    # backbone/head normalization: "bn" (reference parity) | "gn"
    # (GroupNorm: no train/eval statistics gap, batch-size independent —
    # see PointNet2Msg.norm for the measured BN eval-mode pathology)
    norm: str = "bn"
    # basin-confidence head (deviation; no reference counterpart): a small
    # pooled MLP on stop_gradient(backbone features) trained to score how
    # far the canonicalization pose sits from the object's true pose
    # (scripts/train_basin_head.py).  Exists because every UNSUPERVISED
    # per-candidate scorer for the frame-0 orientation search measured
    # flat in the offset (EVIDENCE.md round 5 scorer diagnosis) — this
    # head is supervised on exactly that offset.  stop_gradient makes it
    # provably inert for the main task: adding/training it cannot move
    # seg/NPCS outputs.
    basin_head: bool = False


@dataclass(frozen=True)
class PerturbCfg:
    """Pose perturbation for init-frame noise / augmentation
    (reference config_*.yml `pose_perturb:`; r in degrees)."""
    kind: str = "normal"
    s: float = 0.02
    r: float = 5.0
    t: float = 0.03


@dataclass(frozen=True)
class TrackCfg:
    # one-flag category-aware tracking preset (no reference counterpart —
    # the reference has exactly one tracking behavior):
    #   "reference" — reference semantics, all levers at their defaults
    #   "best"      — the measured best per-category stack (EVIDENCE.md
    #                 round-3/4 sweeps), resolved against the object config
    #                 at load time (config/loader.py::_quality_profile).
    # Explicitly-set track_cfg/* keys always win over the preset.
    quality_profile: str = "reference"
    gt_label: bool = False
    nocs2d_label: bool = False
    nocs2d_path: str = ""
    init_frame_gt: bool = False
    nocs_otf: bool = False
    # FPS working-set multiple for the OTF crop (reference subsamples to
    # 5x num_points, data_utils.py:147-153; 3 trades ~nothing in coverage
    # for +30% single-stream OTF throughput)
    otf_work_factor: int = 5
    # > 0 bounds the per-frame scale ratio to [1/(1+c), 1+c] (deviation;
    # damps scale random-walk under biased NPCS — see compose_track_pose)
    scale_clamp: float = 0.0
    # "exact": global max-min FPS; "grouped": stratified 8-way FPS with
    # num_points/8 sequential picks (the exact single-cloud kernel is
    # latency-bound at ~0.5us/pick) — see ops.farthest_point_sample_grouped_t
    otf_fps_mode: str = "exact"
    # re-aggregate the rotation delta from the per-point predictions
    # weighted by seg confidence instead of the net's uniform masked mean
    # (deviation; the reference aggregates uniformly, networks.py:127-138)
    conf_weighted_delta: bool = False
    # > 1 runs extra per-frame {canonicalize -> nets -> compose} passes
    # from the just-fitted pose (deviation; the reference runs exactly one
    # pass per frame, model.py:454-476); each extra pass costs one more
    # full net evaluation per frame
    refine_iters: int = 1
    # "forward": classic iterative refinement (compose the re-predicted
    # delta); "debias": compose its INVERSE — the residual measured at the
    # fitted pose estimates the predictor's local bias, the dominant term
    # in the measured full-scan drift (EVIDENCE.md round-3)
    refine_mode: str = "debias"
    # rotation source for the tracked pose (deviation; the reference always
    # composes the regressed delta, networks.py:210-232):
    #   "delta" — reference behavior (default)
    #   "npcs"  — absolute masked Procrustes solve from CoordNet's
    #             predicted NPCS (errors don't integrate frame-to-frame,
    #             but each frame pays the full NPCS noise)
    #   "fused" — complementary filter: the delta-composed R pulled toward
    #             the NPCS solve by rot_fit_alpha along the SO(3) geodesic
    #             (the absolute measurement bounds the delta drift)
    rot_fit: str = "delta"
    rot_fit_alpha: float = 0.5
    # != 1 scales the regressed delta's rotation ANGLE before composition
    # (deviation; the reference composes the delta verbatim,
    # networks.py:205-208).  Motivation: the measured under-correction
    # equilibrium (EVIDENCE.md round-3) — the regressor corrects a roughly
    # constant fraction f < 1 of its input canonicalization error at any
    # training scale, so the tracked drift settles where per-frame motion
    # error balances f * drift; a gain of ~1/f restores unit loop gain
    # (proportional control), at the cost of amplifying per-frame noise by
    # the same factor
    delta_gain: float = 1.0
    # > 0 enables in-graph RANSAC outlier rejection in the tracking-time
    # pose fits with that many 3-point hypotheses (deviation; the
    # reference's tracking fit is explicitly part_fit_st_NO_ransac,
    # pose_utils/pose_fit.py:38-53 — it only runs RANSAC offline,
    # align_pose.py:49-93).  For real sensor data where segmentation leaks
    # background points into the part mask; robustifies both the s/t fit
    # and (when rot_fit != "delta") the absolute rotation solve
    fit_ransac: int = 0
    # camera-space inlier threshold for fit_ransac, meters
    fit_ransac_th: float = 0.01
    # tracking-time motion model for the init pose fed to the nets each
    # frame (deviation; the reference always seeds with the last fitted
    # pose verbatim, model.py:409-420):
    #   "none"      — reference behavior (default)
    #   "const_vel" — constant-velocity extrapolation: canonicalize frame t
    #                 by pose_{t-1} advanced by a low-passed estimate of the
    #                 world-frame per-frame delta (scale held).  Under
    #                 smooth motion the regressor then corrects residuals
    #                 instead of the full per-frame motion, removing most of
    #                 the under-correction lag (EVIDENCE.md round-3: the
    #                 drift is a correlated ~0.6 deg/frame bias, i.e. a
    #                 steady-state lag, not a random walk)
    # frame-0 coarse orientation search for GT-less init (deviation; the
    # reference always receives a GT frame-0 pose, model.py:390-400).
    # K > 0 scores K candidate orientations (the cloud-derived guess + a
    # super-Fibonacci SO(3) covering) by CoordNet NPCS self-consistency
    # and seeds the scan with the best descended candidate — extends the
    # measured GT-less recovery envelope (EVIDENCE.md round 5) at the cost
    # of init_search_steps batched CoordNet forwards on frame 0 only
    init_search: int = 0
    # descend-and-score passes per candidate (each = one CoordNet forward
    # at batch B*K plus an absolute similarity fit)
    init_search_steps: int = 2
    # mode-clustering radius (degrees) for candidate selection: descended
    # candidates within tau of each other are one mode, and the densest
    # mode wins (fit-residual tie-break inside it).  Rationale (scorer
    # diagnosis, EVIDENCE.md round 5): every PER-candidate scorer is flat
    # in the offset — out-of-basin candidates make the CoordNet "copy" the
    # canonicalized input, which is self-consistent for any orientation —
    # but in-basin candidates all DESCEND TO THE SAME POSE while copies
    # stay pinned at their ~covering-radius-spaced grid positions, so
    # cross-candidate agreement separates where no per-candidate score
    # does.  <= 0 disables clustering (pure residual argmin, the v1/v2
    # scorer, measured WORSE than no search).
    init_search_tau: float = 10.0
    # candidate selection signal: "mode" = the tau-clustering above
    # (tau <= 0 degrades it to pure residual); "basin" = the supervised
    # basin-confidence head (requires network/basin_head and a checkpoint
    # fine-tuned by scripts/train_basin_head.py) — candidates are scored
    # by the head's logit on their PRE-descent canonicalization and the
    # best candidate's descended pose seeds the scan
    init_search_scorer: str = "mode"
    motion_model: str = "none"
    # fraction of the estimated per-frame delta applied at prediction time.
    # The steady-state rotation lag under constant motion m and correction
    # fraction 1/2 is (1 - gain) * m; gain=1 removes it fully but sits at
    # the loop's stability margin (measured: the raw double-difference
    # predictor diverges ~1.55x/frame in f32), so the default backs off
    motion_gain: float = 0.8
    # low-pass coefficient for the velocity estimate: v' = v + beta *
    # (observed_delta - v) per frame (alpha-beta-filter style); smaller =
    # smoother/laggier velocity acquisition, 1 = raw frame difference
    motion_beta: float = 0.5


@dataclass(frozen=True)
class OptimCfg:
    """Optimizer + schedules (reference config_*.yml optimization block)."""
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    lr_policy: str = "step"
    lr_gamma: float = 0.5
    lr_step_size: int = 20
    lr_clip: float = 1e-5
    # global-norm gradient clip, 0 = off (deviation: the reference never
    # clips, but bf16 training can hit one-off gradient spikes — a measured
    # RotationNet run diverged irrecoverably at step ~2400 without it)
    grad_clip: float = 0.0
    # BN momentum schedule (torch convention: running += m * batch;
    # reference trainer.py:135-145)
    bn_momentum_original: float = 0.1
    bn_momentum_decay: float = 0.5
    bn_momentum_step_size: int = 20
    bn_momentum_min: float = 0.01
    weight_init: str = "xavier"
    batch_size: int = 12
    total_epoch: int = 250


@dataclass(frozen=True)
class Config:
    obj: ObjCfg = ObjCfg()
    network: NetworkCfg = NetworkCfg()
    pointnet: PointNetCfg = PointNetCfg()
    perturb: PerturbCfg = PerturbCfg()
    track: TrackCfg = TrackCfg()
    optim: OptimCfg = OptimCfg()
    num_points: int = 4096
    data_radius: float = 0.6
    # checkpoint every `save_freq` epochs (reference `freq: save:` key,
    # network/train.py:94-95 `(epoch + 1) % cfg['freq']['save'] == 0`)
    save_freq: int = 1
    experiment_dir: str = "runs/exp_tmp"
    coord_exp_dir: str = ""
    coord_resume_epoch: int = -1
    dataset_length: int | None = None
    batch_size: int = 12
    loss_weight: Mapping[str, float] = field(default_factory=lambda: _frozen({
        "rloss": 20.0, "tloss": 5.0, "sloss": 5.0, "corner_loss": 20.0,
        "nocs_loss": 5.0, "seg_loss": 3.0, "nocs_dist_loss": 2.5,
        "nocs_pwm_loss": 2.5,
    }))
    pose_loss_type: Mapping[str, str] = field(default_factory=lambda: _frozen({
        "r": "frob", "s": "l1", "t": "l1", "point": "l1"}))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def num_expr(self) -> str:
        """Experiment name, used to key the dataset split directory
        (reference config.py:48: the experiment dir's last path segment)."""
        return self.experiment_dir.rstrip("/").split("/")[-1] or "exp"


class _frozen(dict):
    """Hashable immutable mapping so Config stays usable as a static arg."""

    def __hash__(self):
        return hash(tuple(sorted(self.items())))

    def _blocked(self, *a, **k):
        raise TypeError("frozen mapping")

    __setitem__ = __delitem__ = update = pop = popitem = clear = _blocked

    def __reduce__(self):
        # pickled as a call with its items (a dict's pickle would set them
        # one by one), so a Config can go to another process
        return (_frozen, (dict(self),))


def frozen_map(d: Mapping) -> Mapping:
    return _frozen(d)


def tuplify(x):
    """Recursively convert lists (from YAML) to tuples for hashability."""
    if isinstance(x, (list, tuple)):
        return tuple(tuplify(v) for v in x)
    return x
