"""Shared setup for the port's parity tests (tests/test_torch_*.py): the
same tiny configuration built from each package's own schema, numpy views of
flax variables, and seeded perturbations so converted norm statistics are
not identities."""
import numpy as np

BOTTLE = dict(category="1", name="bottle", num_parts=1, num_joints=0,
              tree=(-1,), sym=True, extra_dims=1)
LAPTOP = dict(category="laptop", name="laptop", num_parts=2, num_joints=1,
              tree=(-1, 0), sym=False, main_axis=(0,), extra_dims=0)
OBJECTS = {"bottle": BOTTLE, "laptop": LAPTOP}


def tiny_config(schema, obj: str = "bottle", norm: str = "bn",
                num_points: int = 256):
    """A few-layer, narrow-width Config from `schema` (the JAX package's or
    the port's config.schema module)."""
    pn = schema.PointNetCfg(
        sa1=schema.SAMsgCfg(npoint=32, radius_list=(0.1, 0.2),
                            nsample_list=(8, 16),
                            mlp_list=((8, 16), (8, 16))),
        sa2=schema.SAMsgCfg(npoint=8, radius_list=(0.4,), nsample_list=(8,),
                            mlp_list=((16, 32),)),
        sa3_mlp=(32, 64), fp3_mlp=(32,), fp2_mlp=(32,), fp1_mlp=(32,))
    return schema.Config(
        obj=schema.ObjCfg(**OBJECTS[obj]),
        network=schema.NetworkCfg(backbone_out_dim=32, nocs_head_dims=(16,),
                                  norm=norm),
        pointnet=pn, num_points=num_points,
        track=schema.TrackCfg(init_frame_gt=True))


def to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def perturb(tree, rng):
    """Seeded, nontrivial norm parameters and BN statistics (var > 0)."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = perturb(v, rng)
        elif k == "var":
            out[k] = (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        elif k in ("mean", "scale", "bias"):
            out[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def cloud(rng, *shape):
    return (rng.randn(*shape, 3) * 0.3).astype(np.float32)


def assert_tree_equal(got, want, roots=(), where="item"):
    """Dataset items (and caches) bit for bit: the same keys and types,
    arrays equal in dtype, shape and value, strings equal once each
    package's fixture root in `roots` ((port root, JAX root), ...) is
    replaced by the other's."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_tree_equal(got[k], want[k], roots, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, roots, f"{where}[{i}]")
    elif isinstance(want, str):
        for port_root, jax_root in roots:
            got = got.replace(port_root, jax_root)
        assert got == want, where
    elif isinstance(want, np.ndarray) or isinstance(want, np.generic):
        assert type(got) is type(want), (where, type(got), type(want))
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def png_filter_row(kind: int, cur: bytes, prev: bytes, bpp: int) -> bytes:
    """One scanline filtered with PNG filter `kind` (0-4), byte by byte as
    the PNG specification writes it; `prev` the unfiltered row above."""
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes(out)
