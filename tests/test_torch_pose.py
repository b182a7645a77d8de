"""The port's pose math against the JAX package's: rotations, part_dof,
procrustes, pose_fit and metrics on the same seeded numpy inputs.

Tolerance atol 1e-5: float32 3x3 algebra, summed in another order by each
framework."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.models import coordnet as jcoordnet
from captra_tpu.pose import metrics as jmetrics
from captra_tpu.pose import part_dof as jdof
from captra_tpu.pose import pose_fit as jfit
from captra_tpu.pose import procrustes as jpro
from captra_tpu.pose import rotations as jrot
from captra_tpu_torch.models import coordnet
from captra_tpu_torch.pose import metrics, part_dof, pose_fit, procrustes
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.utils.precision import f32_precision

ATOL = 1e-5


def _rotations(rng, *shape):
    q = rng.randn(*shape, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jrot.quat_to_matrix(jnp.asarray(q, jnp.float32)))


def _close(got, want, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)


def _both(jfn, tfn, *args, **kw):
    """Call the JAX and the port function on the same numpy arguments."""
    want = jfn(*(jnp.asarray(a) for a in args), **kw)
    got = tfn(*(torch.from_numpy(np.array(a)) for a in args),
              **kw)
    return got, want


def _rotation_cases():
    rng = np.random.RandomState(0)
    vec = rng.randn(4, 5, 3).astype(np.float32)
    vec[0, 0] = 0.0                         # zero row: the fallback
    q = rng.randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q2 = rng.randn(6, 4).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    R = _rotations(rng, 6)
    R2 = _rotations(rng, 6)
    axis = rng.randn(6, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    theta = rng.uniform(0.1, 3.0, 6).astype(np.float32)
    six = rng.randn(3, 7, 6).astype(np.float32)
    mats = rng.randn(5, 3, 3).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    return {
        "normalize_vector": (vec,),
        "normalize_quat": (q * 3.0,),
        "quat_multiply": (q, q2),
        "quat_conjugate": (q,),
        "quat_rotate": (q, vec[0, :, :].repeat(2, 0)[:6]),
        "quat_to_matrix": (q,),
        "matrix_to_quat": (R,),
        "axis_theta_to_quat": (axis, theta),
        "quat_to_axis_theta": (q,),
        "axis_theta_to_matrix": (axis, theta),
        "matrix_to_axis_theta": (R,),
        "matrix_to_rotvec": (R,),
        "rotvec_to_matrix": (axis * theta[:, None],),
        "ortho6d_to_matrix": (six,),
        "gram_schmidt_3x3": (mats,),
        "yvec_to_matrix": (vec,),
        "so3_interpolate": (R, R2),
    }


@pytest.mark.parametrize("name", sorted(_rotation_cases()))
def test_rotations_match_jax(name):
    args = _rotation_cases()[name]
    kw = {"alpha": 0.3} if name == "so3_interpolate" else {}
    got, want = _both(getattr(jrot, name), getattr(rot, name), *args, **kw)
    _close(got, want)


def _pose_pair(rng, B=2, P=3):
    R = _rotations(rng, B, P)
    t = rng.randn(B, P, 3, 1).astype(np.float32)
    s = rng.uniform(0.2, 1.5, (B, P)).astype(np.float32)
    return (jdof.Pose(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)),
            part_dof.Pose(*(torch.from_numpy(a) for a in (R, t, s))))


@pytest.mark.parametrize("name", ["apply_pose", "inverse_apply_pose",
                                  "canonicalize_columns"])
def test_pose_application_matches_jax(name):
    rng = np.random.RandomState(1)
    jp, tp = _pose_pair(rng)
    shape = (2, 3, 3, 40) if name == "canonicalize_columns" else (2, 3, 40, 3)
    pts = rng.randn(*shape).astype(np.float32)
    want = getattr(jdof, name)(jp, jnp.asarray(pts))
    got = getattr(part_dof, name)(tp, torch.from_numpy(pts))
    _close(got, want)


def test_merge_delta_pose_matches_jax():
    rng = np.random.RandomState(2)
    jp, tp = _pose_pair(rng)
    dR = _rotations(rng, 2, 3)
    ds = rng.uniform(0.5, 1.5, (2, 3)).astype(np.float32)
    dt = rng.randn(2, 3, 3, 1).astype(np.float32)
    want = jdof.merge_delta_pose(jp, jnp.asarray(dR), jnp.asarray(ds),
                                 jnp.asarray(dt))
    got = part_dof.merge_delta_pose(tp, *(torch.from_numpy(a)
                                          for a in (dR, ds, dt)))
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got, f), getattr(want, f))


def test_tree_root_and_identity_match_jax():
    for tree in [(-1,), (-1, 0), (1, -1, 1, 0)]:
        assert part_dof.tree_root(tree) == jdof.tree_root(tree)
    with pytest.raises(ValueError, match="one root"):
        part_dof.tree_root((-1, -1))
    ident = part_dof.Pose.identity((2, 3))
    jident = jdof.Pose.identity((2, 3))
    for f in ("rotation", "translation", "scale"):
        _close(getattr(ident, f), getattr(jident, f), atol=0)


@pytest.mark.parametrize("yaxis_only", [False, True])
def test_metrics_match_jax(yaxis_only):
    rng = np.random.RandomState(3)
    jgt, tgt = _pose_pair(rng)
    jpred, tpred = _pose_pair(rng)
    # degrees: arccos amplifies the float32 trace rounding
    _close(metrics.rot_diff_degree(tgt.rotation, tpred.rotation,
                                   yaxis_only=yaxis_only),
           jmetrics.rot_diff_degree(jgt.rotation, jpred.rotation,
                                    yaxis_only=yaxis_only), atol=1e-3)
    _close(metrics.trans_diff(tgt.translation, tpred.translation),
           jmetrics.trans_diff(jgt.translation, jpred.translation))
    _close(metrics.scale_diff(tgt.scale, tpred.scale),
           jmetrics.scale_diff(jgt.scale, jpred.scale))
    got, want = _both(jmetrics.theta_diff, metrics.theta_diff,
                      rng.randn(5).astype(np.float32),
                      rng.randn(5).astype(np.float32))
    _close(got, want)


def _fit_inputs(seed, B=2, P=2, N=64):
    """NPCS sources, posed noisy camera targets, a binary mask."""
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, P, N, 3) - 0.5).astype(np.float32)
    R = _rotations(rng, B, P)
    s = rng.uniform(0.2, 0.5, (B, P)).astype(np.float32)
    t = rng.randn(B, P, 1, 3).astype(np.float32)
    tgt = (s[..., None, None] * src @ np.swapaxes(R, -1, -2) + t
           + 0.01 * rng.randn(B, P, N, 3)).astype(np.float32)
    mask = (rng.rand(B, P, N) > 0.3).astype(np.float32)
    return src, tgt, mask, R


def test_masked_moments_match_jax():
    src, tgt, mask, _ = _fit_inputs(4)
    got, want = _both(jpro.masked_center, procrustes.masked_center, src, mask)
    _close(got, want)
    _, sc = jpro.masked_center(jnp.asarray(src), jnp.asarray(mask))
    _, tc = jpro.masked_center(jnp.asarray(tgt), jnp.asarray(mask))
    sc, tc = np.asarray(sc), np.asarray(tc)
    got, want = _both(jpro.scale_fit, procrustes.scale_fit, sc, tc, mask)
    _close(got, want)
    got, want = _both(jpro.translation_fit, procrustes.translation_fit, src,
                      tgt, mask)
    _close(got, want)


def test_rotation_fits_match_jax():
    src, tgt, mask, _ = _fit_inputs(5)
    got, want = _both(jpro.kabsch_rotation, procrustes.kabsch_rotation,
                      src, tgt)
    _close(got, want)
    got, want = _both(jpro.rot2d_fit, procrustes.rot2d_fit, src[..., ::2],
                      tgt[..., ::2])
    _close(got, want)
    got, want = _both(jpro.rot_around_yaxis_to_3d,
                      procrustes.rot_around_yaxis_to_3d,
                      np.asarray(want))
    _close(got, want)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("given_rotation", [False, True])
def test_similarity_fit_matches_jax(sym, given_rotation):
    src, tgt, mask, R = _fit_inputs(6)
    kw = {"sym": sym}
    jkw, tkw = dict(kw), dict(kw)
    if given_rotation:
        jkw["rotation"] = jnp.asarray(R)
        tkw["rotation"] = torch.from_numpy(R)
    want = jpro.similarity_fit(jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(mask), **jkw)
    got = procrustes.similarity_fit(torch.from_numpy(src),
                                    torch.from_numpy(tgt),
                                    torch.from_numpy(mask), **tkw)
    _close(got, want)


@pytest.mark.parametrize("sym", [False, True])
def test_part_fit_st_matches_jax(sym):
    """The tracking fit, with an empty part, a 3-point part (too few to be
    valid) and label 2 = background selecting no part."""
    src, tgt, _, R = _fit_inputs(7)
    rng = np.random.RandomState(8)
    labels = rng.randint(0, 3, (2, 64))
    labels[1] = np.where(labels[1] == 1, 0, labels[1])   # part 1 empty
    labels[1, :3] = 1                                    # ... but 3 points
    args = (labels, src, tgt, R)
    want_pose, want_valid = jfit.part_fit_st(
        *(jnp.asarray(a) for a in args), num_parts=2, sym=sym, min_scale=1e-4)
    got_pose, got_valid = pose_fit.part_fit_st(
        *(torch.from_numpy(a) for a in args), num_parts=2, sym=sym,
        min_scale=1e-4)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert not got_valid[1, 1]
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got_pose, f), getattr(want_pose, f))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("given_scale", [False, True])
def test_coordnet_solve_st_matches_jax(sym, given_scale):
    """CoordNet's s/t solve under a given rotation, with an empty part
    falling back to the init pose."""
    rng = np.random.RandomState(10)
    B, P, N = 2, 2, 64
    src, tgt, _, R = _fit_inputs(11, B, P, N)
    nocs = np.swapaxes(src, 1, 2).reshape(B, N, 3 * P).copy()
    mean = tgt.mean(axis=(1, 2)).astype(np.float32)            # [B, 3]
    points = (tgt[:, 0] - mean[:, None]).astype(np.float32)    # [B, N, 3]
    seg = rng.rand(B, N, P + 1).astype(np.float32)
    labels = rng.randint(0, P + 1, (B, N))
    labels[1] = np.where(labels[1] == 1, 0, labels[1])
    scale = rng.uniform(0.2, 0.5, (B, P)).astype(np.float32)
    jinit, tinit = _pose_pair(rng, B, P)
    args = (seg, nocs, points, mean, labels, R)
    kw = dict(num_parts=P, sym=sym)
    want = jcoordnet.solve_st(
        *(jnp.asarray(a) for a in args), jinit,
        given_scale=jnp.asarray(scale) if given_scale else None, **kw)
    got = coordnet.solve_st(
        *(torch.from_numpy(a) for a in args), tinit,
        given_scale=torch.from_numpy(scale) if given_scale else None, **kw)
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got, f), getattr(want, f))
    _close(got.scale[1, 1], jinit.scale[1, 1], atol=0)


def test_labels_and_filter_valid_match_jax():
    labels = np.array([[0, 1, 2, 3, 1, 0]])
    got, want = _both(lambda x: jfit.labels_to_part_mask(x, 2),
                      lambda x: pose_fit.labels_to_part_mask(x, 2), labels)
    _close(got, want, atol=0)
    rng = np.random.RandomState(9)
    jp, tp = _pose_pair(rng, B=1, P=4)
    scale = np.array([[1.0, np.nan, 1e-5, 0.5]], np.float32)
    trans = np.asarray(jp.translation).copy()
    trans[0, 3, 1, 0] = np.inf
    jp = jdof.Pose(jp.rotation, jnp.asarray(trans), jnp.asarray(scale))
    tp = part_dof.Pose(tp.rotation, torch.from_numpy(trans),
                       torch.from_numpy(scale))
    valid = np.ones((1, 4), bool)
    for min_scale in (None, 1e-4):
        np.testing.assert_array_equal(
            pose_fit.filter_valid(tp, torch.from_numpy(valid),
                                  min_scale).numpy(),
            np.asarray(jfit.filter_valid(jp, jnp.asarray(valid), min_scale)))


def test_f32_precision_turns_tf32_off_and_restores():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        seen = []

        @f32_precision
        def probe():
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))

        probe()
        with f32_precision():
            probe()
        assert seen == [(False, False), (False, False)]
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
