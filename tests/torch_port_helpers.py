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


def tree_leaves(tree, path=()):
    """(slash path, numpy array) of every leaf of a nested dict, in sorted
    key order."""
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


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


def jax_pose_noise(key, shape, kind):
    """The draws `add_noise_to_pose` makes from `key` (part_dof.py:209-224,
    rotations.py:218-225), under the port's names, as numpy arrays."""
    import jax
    k_rot, k_s, k_tn, k_td = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_rot)

    def rand(k, s):
        return (jax.random.uniform(k, s) if kind == "uniform"
                else jax.random.normal(k, s))

    out = {"rot_angle": rand(k1, shape),
           "rot_quat": jax.random.normal(k2, shape + (4,)),
           "scale": rand(k_s, shape), "trans_norm": rand(k_tn, shape),
           "trans_dir": rand(k_td, shape + (3,))}
    return {k: np.array(v) for k, v in out.items()}


def jax_pwm_indices(key, labels, pwm_num):
    """The sample `sym_nocs_loss` draws from `key` (losses.py:98-101) over
    labels [B, N], as numpy [B, pwm_num]."""
    import jax
    import jax.numpy as jnp
    labels = jnp.asarray(labels)
    logits = jnp.where(labels == 0, 0.0, -1e9)
    keys = jax.random.split(key, labels.shape[0])
    return np.array(jax.vmap(lambda k, lg: jax.random.categorical(
        k, lg, shape=(pwm_num,)))(keys, logits))


def jax_train_draws(cfg, key, labels):
    """The draws of one JAX train / eval step with `key` (trainer.py:138,
    :213), for the port's `draws=` (labels: the ones the pairwise sample
    is over)."""
    import jax
    import torch
    B = np.asarray(labels).shape[0]
    P = cfg.obj.num_parts
    if cfg.network.type == "rot":
        return {"noise": {k: torch.from_numpy(v) for k, v in jax_pose_noise(
            key, (B, P), cfg.perturb.kind).items()}}
    k_noise, k_pwm = jax.random.split(key)
    draws = {"noise": {k: torch.from_numpy(v) for k, v in jax_pose_noise(
        k_noise, (B, P), cfg.perturb.kind).items()}}
    if cfg.obj.sym:
        draws["pwm_idx"] = torch.from_numpy(
            jax_pwm_indices(k_pwm, labels, cfg.network.pwm_num))
    return draws
