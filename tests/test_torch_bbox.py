"""The port's 3D boxes and IoU (`captra_tpu_torch/pose/bbox.py`) against the
JAX package's (`captra_tpu/pose/bbox.py`) on seeded boxes and poses.

Tolerances:
- exact: box vertices, the y-axis mask, the predicted NPCS corners, the
  grid's values, and the inside test for points off the box faces;
- 1e-6: posed vertices and the y rotations (float32 matmul and cos / sin);
- the grid IoU: XLA may contract the JAX package's projection sums into
  FMAs and the port does not, so a grid point within a rounding of a face
  can fall on either side (on these boxes the two agree exactly).  Oriented boxes put few grid points there:
  at most 2 points of the union a pair.  An axis-aligned box puts a whole
  face layer of the grid there: at most 2 * 50^2 points of the union;
- the axis-aligned IoU: 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.pose import bbox as jbbox
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.pose.rotations import quat_to_matrix as jquat
from captra_tpu_torch.pose import bbox as tbbox
from captra_tpu_torch.pose.part_dof import Pose

NRES = 50
ORIENTED_POINTS = 2
FACE_POINTS = 2 * NRES ** 2


def _corners(rng, *shape):
    """Boxes [*shape, 2, 3] (min, max) around a small offset."""
    center = rng.uniform(-0.05, 0.05, shape + (3,))
    half = rng.uniform(0.05, 0.2, shape + (3,))
    return np.stack([center - half, center + half], -2).astype(np.float32)


def _poses(rng, *shape, identity: bool = False):
    q = rng.randn(*shape, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = (np.broadcast_to(np.eye(3, dtype=np.float32), shape + (3, 3))
           if identity else np.asarray(jquat(jnp.asarray(q, jnp.float32))))
    return dict(rotation=np.ascontiguousarray(rot, np.float32),
                translation=rng.uniform(-0.05, 0.05, shape + (3, 1)).astype(
                    np.float32),
                scale=rng.uniform(0.8, 1.2, shape).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _both_poses(p):
    return (JPose(**{k: jnp.asarray(v) for k, v in p.items()}),
            Pose(**{k: _t(v) for k, v in p.items()}))


def _union(b1, b2):
    """Grid points in either box (the port's count, float64)."""
    both = torch.cat([b1, b2], -2)
    bmin, bmax = both.amin(-2), both.amax(-2)
    grid = torch.from_numpy(tbbox._unit_grid(NRES))
    pts = bmin[..., None, :] + grid * (bmax - bmin)[..., None, :]
    inside = tbbox.pts_inside_box(pts, b1) | tbbox.pts_inside_box(pts, b2)
    return inside.sum(-1).double().numpy()


@pytest.mark.parametrize("nres", [2, 7, 50, 64])
def test_grid_values_equal_jnp_linspace(nres):
    lin = np.asarray(jnp.linspace(0.0, 1.0, nres))
    grid = tbbox._unit_grid(nres)
    np.testing.assert_array_equal(grid[:nres, 2], lin)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    np.testing.assert_array_equal(grid, np.stack([gx, gy, gz], -1)
                                  .reshape(-1, 3))


def test_box_vertices_and_y_axis_exact():
    c = _corners(np.random.RandomState(0), 3, 2)
    np.testing.assert_array_equal(tbbox.bbox_from_corners(_t(c)).numpy(),
                                  np.asarray(jbbox.bbox_from_corners(c)))
    np.testing.assert_array_equal(tbbox.yaxis_from_corners(_t(c)).numpy(),
                                  np.asarray(jbbox.yaxis_from_corners(c)))


def test_pts_inside_box_exact_off_the_faces():
    rng = np.random.RandomState(1)
    box = np.asarray(jbbox.posed_bbox_from_part(
        _both_poses(_poses(rng, 2, 1))[0], _corners(rng, 2, 1)))[:, 0]
    pts = rng.uniform(-0.4, 0.4, (2, 4000, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jbbox.pts_inside_box)(pts, box))
    got = tbbox.pts_inside_box(_t(pts), _t(box)).numpy()
    # distance (in the edge's own units) from each slab's two faces
    e = [box[:, i] - box[:, 0] for i in (2, 4, 1)]
    off = np.ones(want.shape, bool)
    for u in e:
        p = np.einsum("bmi,bi->bm", pts.astype(np.float64) - box[:, :1],
                      u.astype(np.float64))
        uu = np.einsum("bi,bi->b", u, u)[:, None]
        off &= np.minimum(np.abs(p), np.abs(p - uu)) > 1e-5 * uu
    assert off.mean() > 0.99 and want.any() and (~want).any()
    np.testing.assert_array_equal(got[off], want[off])


def test_posed_boxes_and_y_rotations():
    rng = np.random.RandomState(2)
    c = _corners(rng, 2, 2)
    jp, tp = _both_poses(_poses(rng, 2, 2))
    np.testing.assert_allclose(
        tbbox.posed_bbox_from_part(tp, _t(c)).numpy(),
        np.asarray(jbbox.posed_bbox_from_part(jp, c)), atol=1e-6)
    np.testing.assert_allclose(tbbox._y_rotation_matrices(20).numpy(),
                               np.asarray(jbbox._y_rotation_matrices(20)),
                               atol=1e-6)


def _posed_pairs(seed, identity=False):
    rng = np.random.RandomState(seed)
    c1, c2 = _corners(rng, 3, 2), _corners(rng, 3, 2)
    p1 = _both_poses(_poses(rng, 3, 2, identity=identity))
    p2 = _both_poses(_poses(rng, 3, 2, identity=identity))
    jb = [np.asarray(jbbox.posed_bbox_from_part(p[0], c))
          for p, c in ((p1, c1), (p2, c2))]
    return jb


@pytest.mark.parametrize("identity,points", [(False, ORIENTED_POINTS),
                                             (True, FACE_POINTS)])
def test_grid_iou_matches_jax_within_the_face_bound(identity, points):
    b1, b2 = _posed_pairs(3, identity)
    want = np.asarray(jax.jit(jbbox.iou_3d)(b1, b2))
    got = tbbox.iou_3d(_t(b1), _t(b2)).numpy()
    assert got.shape == want.shape == (3, 2)
    assert (want > 0).any()
    bound = points / np.maximum(_union(_t(b1), _t(b2)), 1.0)
    assert np.all(np.abs(got - want) <= bound), (got - want, bound)


def test_axis_aligned_iou_matches_jax():
    b1, b2 = _posed_pairs(4)
    np.testing.assert_allclose(tbbox.aabb_iou_3d(_t(b1), _t(b2)).numpy(),
                               np.asarray(jbbox.aabb_iou_3d(b1, b2)),
                               atol=1e-6)


def test_empty_union_gives_one():
    flat = np.zeros((1, 8, 3), np.float32)
    assert float(tbbox.iou_3d(_t(flat), _t(flat))[0]) == 1.0


def test_pred_nocs_corners_exact():
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 4, (2, 64))       # label 3: background
    labels[1][labels[1] == 1] = 0             # part 1 empty in cloud 1
    nocs = rng.randn(2, 64, 3).astype(np.float32)
    got = tbbox.pred_nocs_corners(_t(labels), _t(nocs), 3).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jbbox.pred_nocs_corners(labels, nocs, 3)))
    assert not got[1, 1].any()


@pytest.mark.parametrize("nocs", [False, True])
@pytest.mark.parametrize("sym", [False, True])
def test_eval_single_part_iou_matches_jax(nocs, sym):
    """The symmetric sweep over the grid IoU (no shipped config combines
    them) runs 4 rotations, not 20: each holds 4 grids of 125,000 points."""
    n_sym = 4 if sym and not nocs else 20
    rng = np.random.RandomState(6)
    gc, pc = _corners(rng, 2, 2), _corners(rng, 2, 2)
    gp, pp = _poses(rng, 2, 2), _poses(rng, 2, 2)
    # the prediction near the GT, so the IoUs are not all 0
    pp["translation"] = gp["translation"] + 0.01 * pp["translation"]
    (jg, tg), (jpp, tpp) = _both_poses(gp), _both_poses(pp)
    want = jax.jit(lambda *a: jbbox.eval_single_part_iou(
        *a, nocs=nocs, sym=sym, n_sym=n_sym))(gc, pc, jg, jpp)
    got = tbbox.eval_single_part_iou(_t(gc), _t(pc), tg, tpp, nocs=nocs,
                                     sym=sym, n_sym=n_sym)
    assert sorted(got) == sorted(want) == ["gt_bbox_iou", "iou", "npcs_iou"]
    assert float(np.max(want["iou"])) > 0.05
    for k in got:
        w = np.asarray(want[k])
        if nocs:
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6)
        else:
            bound = _grid_bound(k, _t(gc), _t(pc), tg, tpp, sym, n_sym)
            assert np.all(np.abs(got[k].numpy() - w) <= bound), k


def _grid_bound(metric, gc, pc, gt_pose, pred_pose, sym, n_sym=20):
    """The grid IoU's bound for one metric of `eval_single_part_iou`: the
    NPCS boxes are axis-aligned (a face layer), the posed ones oriented;
    over the symmetric sweep, against the least union of its pairs."""
    if metric == "npcs_iou":
        return FACE_POINTS / np.maximum(_union(
            tbbox.bbox_from_corners(gc), tbbox.bbox_from_corners(pc)), 1.0)
    pred = tbbox.posed_bbox_from_part(
        pred_pose, pc if metric == "iou" else gc)
    rots = tbbox._y_rotation_matrices(n_sym) if sym else torch.eye(3)[None]
    unions = [_union(tbbox.posed_bbox_from_part(
        Pose(gt_pose.rotation @ r, gt_pose.translation, gt_pose.scale), gc),
        pred) for r in rots]
    return ORIENTED_POINTS / np.maximum(np.min(unions, axis=0), 1.0)
