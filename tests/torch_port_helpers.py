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


def jax_pose_batch_draws(key, B, N, P):
    """The draws `device_pose_batch` makes from `key` (synthetic.py:255-
    273), raw, under the port's names, as CPU tensors."""
    import jax
    import torch
    k_q, k_t, k_s, k_j, k_n = jax.random.split(key, 5)
    out = {"quat": jax.random.normal(k_q, (B, 4)),
           "trans": jax.random.uniform(k_t, (B, 3)),
           "scale": jax.random.uniform(k_s, (B,)),
           "theta": jax.random.uniform(k_j, (B, P)),
           "noise": jax.random.normal(k_n, (B, N, 3))}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_trajectory_draws(key, B, N, P, T):
    """The draws `device_trajectory_batch` makes from `key`
    (synthetic.py:329-348), raw, under the port's names, as CPU tensors."""
    import jax
    import torch
    k_q, k_t, k_s, k_j, k_dj, k_ax, k_dt, k_n = jax.random.split(key, 8)
    out = {"quat": jax.random.normal(k_q, (B, 4)),
           "trans": jax.random.uniform(k_t, (B, 3)),
           "scale": jax.random.uniform(k_s, (B,)),
           "theta0": jax.random.uniform(k_j, (B, P)),
           "djoint": jax.random.uniform(k_dj, (B, P)),
           "axis": jax.random.normal(k_ax, (B, 3)),
           "dtrans": jax.random.normal(k_dt, (B, 3)),
           "noise": jax.random.normal(k_n, (T * B, N, 3)).reshape(
               T, B, N, 3)}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_round_draws(key, pool_labels, coord_cfg, rot_cfg, track_cfg, *,
                    traj_batch, traj_frames, minibatch, plain_steps=0,
                    freeze_coord=False):
    """The draws one JAX fine-tune round makes from `key`
    (rollout.py:108-174), in the structure of the port's
    `make_finetune_round(...).draw`: the round key split six ways (geometry,
    trajectories, init noise, permutation, train, plain), the permutation
    cut to n_mb * minibatch and cut into minibatches, one key a minibatch
    split into the CoordNet's and the RotNet's, and each plain step's key
    split four ways.  pool_labels: the pool's labels [G, N] (the pairwise
    NOCS sample is over a minibatch's GT labels)."""
    import jax
    import torch
    pool_labels = np.asarray(pool_labels)
    G, N = pool_labels.shape
    P = track_cfg.obj.num_parts
    M = (traj_frames - 1) * traj_batch
    n_mb = M // minibatch
    k_geo, k_traj, k_init, k_perm, k_train, k_plain = jax.random.split(key, 6)
    geo = np.array(jax.random.randint(k_geo, (traj_batch,), 0, G))
    perm = np.array(jax.random.permutation(k_perm, M))
    labels = np.tile(pool_labels[geo], (traj_frames - 1, 1))
    init = None
    if not track_cfg.track.init_frame_gt:
        init = {k: torch.from_numpy(v) for k, v in jax_pose_noise(
            k_init, (traj_batch, P), track_cfg.perturb.kind).items()}
    train = []
    mbs = perm[:n_mb * minibatch].reshape(n_mb, minibatch)
    for i, k in enumerate(jax.random.split(k_train, n_mb)):
        kc, kr = jax.random.split(k)
        train.append({
            "coord": (None if freeze_coord else
                      jax_train_draws(coord_cfg, kc, labels[mbs[i]])),
            "rot": jax_train_draws(rot_cfg, kr, labels[mbs[i]])})
    plain = []
    if plain_steps:
        for k in jax.random.split(k_plain, plain_steps):
            ks, kp, kc, kr = jax.random.split(k, 4)
            pidx = np.array(jax.random.randint(ks, (minibatch,), 0, G))
            plain.append({
                "geo": torch.from_numpy(pidx),
                "pose": jax_pose_batch_draws(kp, minibatch, N, P),
                "coord": (None if freeze_coord else jax_train_draws(
                    coord_cfg, kc, pool_labels[pidx])),
                "rot": jax_train_draws(rot_cfg, kr, pool_labels[pidx])})
    return {"geo": torch.from_numpy(geo),
            "traj": jax_trajectory_draws(k_traj, traj_batch, N, P,
                                         traj_frames),
            "init": init, "perm": torch.from_numpy(perm), "train": train,
            "plain": plain}


# ---------------------------------------------------------------------------
# state dicts in the reference's torch layout (numpy and torch only: the
# card's tests and chip_smoke.py use them too)
# ---------------------------------------------------------------------------

def reference_backbone_sd(prefix, pn, in_dim, rng, out_dim=32):
    """A reference PointNet2Msg state dict under `prefix`, laid out as
    tests/test_convert.py's `_fake_backbone_sd` lays it out (1x1 Conv2d in
    the set abstractions, Conv1d in the feature propagations, BN after
    each), seeded from `rng`, weights scaled by 1/sqrt(fan-in)."""
    import torch
    sd = {}

    def conv(key, cin, cout, spatial):
        shape = (cout, cin) + (1,) * spatial
        sd[f"{key}.weight"] = torch.tensor(
            (rng.randn(*shape) / np.sqrt(cin)).astype(np.float32))
        sd[f"{key}.bias"] = torch.tensor(rng.randn(cout).astype(np.float32))

    def bn(key, c):
        sd[f"{key}.weight"] = torch.tensor(np.ones(c, np.float32))
        sd[f"{key}.bias"] = torch.tensor(np.zeros(c, np.float32))
        sd[f"{key}.running_mean"] = torch.tensor(
            rng.randn(c).astype(np.float32) * 0.1)
        sd[f"{key}.running_var"] = torch.tensor(
            np.abs(rng.randn(c).astype(np.float32)) + 1.0)

    ch = in_dim + 3
    sa_out = {}
    for name, sa in (("sa1", pn.sa1), ("sa2", pn.sa2)):
        outs = 0
        for i, mlp in enumerate(sa.mlp_list):
            last = ch
            for j, c in enumerate(mlp):
                conv(f"{prefix}.{name}.conv_blocks.{i}.{j}", last, c, 2)
                bn(f"{prefix}.{name}.bn_blocks.{i}.{j}", c)
                last = c
            outs += last
        sa_out[name] = outs
        ch = outs + 3
    last = ch
    for j, c in enumerate(pn.sa3_mlp):
        conv(f"{prefix}.sa3.mlp_convs.{j}", last, c, 2)
        bn(f"{prefix}.sa3.mlp_bns.{j}", c)
        last = c
    fp_in = {"fp3": sa_out["sa2"] + pn.sa3_mlp[-1],
             "fp2": sa_out["sa1"] + pn.fp3_mlp[-1],
             "fp1": in_dim + 3 + pn.fp2_mlp[-1]}
    for fp, mlp in (("fp3", pn.fp3_mlp), ("fp2", pn.fp2_mlp),
                    ("fp1", pn.fp1_mlp)):
        last = fp_in[fp]
        for j, c in enumerate(mlp):
            conv(f"{prefix}.{fp}.mlp_convs.{j}", last, c, 1)
            bn(f"{prefix}.{fp}.mlp_bns.{j}", c)
            last = c
    conv(f"{prefix}.conv1", pn.fp1_mlp[-1], out_dim, 1)
    bn(f"{prefix}.bn1", out_dim)
    return sd


def reference_coordnet_sd(cfg, prefix, seed):
    """A reference CoordNet state dict under `prefix` (`net`, or
    `npcs_net` in a composed tracking checkpoint): the backbone, the seg
    head (one conv) and the NOCS head ([conv, BN, ReLU] per hidden layer,
    then conv), seeded from `seed`."""
    import torch
    rng = np.random.RandomState(seed)
    out = cfg.network.backbone_out_dim
    P = cfg.obj.num_parts
    sd = reference_backbone_sd(f"{prefix}.backbone", cfg.pointnet, 3, rng,
                               out)

    def conv(key, cin, cout):
        sd[f"{key}.weight"] = torch.tensor(
            (rng.randn(cout, cin, 1) / np.sqrt(cin)).astype(np.float32))
        sd[f"{key}.bias"] = torch.tensor(rng.randn(cout).astype(np.float32))

    conv(f"{prefix}.seg_head.0", out, P + cfg.obj.extra_dims)
    last, idx = out, 0
    for c in cfg.network.nocs_head_dims:
        conv(f"{prefix}.nocs_head.{idx}", last, c)
        bn = f"{prefix}.nocs_head.{idx + 1}"
        sd[f"{bn}.weight"] = torch.tensor(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{bn}.bias"] = torch.tensor(
            (rng.randn(c) * 0.1).astype(np.float32))
        sd[f"{bn}.running_mean"] = torch.tensor(
            (rng.randn(c) * 0.1).astype(np.float32))
        sd[f"{bn}.running_var"] = torch.tensor(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(7)
        last, idx = c, idx + 3
    conv(f"{prefix}.nocs_head.{idx}", last, 3 * P)
    return sd


def reference_rotnet_sd(cfg, prefix, seed):
    """A reference PartCanonNet state dict under `prefix`: the encoder and
    one rotation head a part (MLPConv1d [conv, GroupNorm, ReLU] x 3, then
    conv: Sequential indices 0, 1 / 3, 4 / 6, 7 / 9), seeded from `seed`.
    The last layer's bias leans the rotation's rep to the identity (the x
    and y axes; the y axis of a symmetric part), so its per-point
    orthonormalisation is well conditioned."""
    import torch
    rng = np.random.RandomState(seed)
    sd = reference_backbone_sd(f"{prefix}.regress_net.encoder",
                               cfg.pointnet, 0, rng,
                               cfg.network.backbone_out_dim)
    dims = [cfg.network.backbone_out_dim, 512, 512, 256,
            3 if cfg.obj.sym else 6]
    for p in range(cfg.obj.num_parts):
        base = f"{prefix}.regress_net.pose_pred.rtvec_head.{p}.model"
        for li, ci in enumerate((0, 3, 6, 9)):
            cin, cout = dims[li], dims[li + 1]
            w = (rng.randn(cout, cin, 1) / np.sqrt(cin)).astype(np.float32)
            b = (rng.randn(cout) * 0.1).astype(np.float32)
            if li == 3:
                b = np.float32(3.0) * np.eye(3, dtype=np.float32)[
                    1 if cfg.obj.sym else slice(0, 2)].reshape(-1)
            sd[f"{base}.{ci}.weight"] = torch.tensor(w)
            sd[f"{base}.{ci}.bias"] = torch.tensor(b)
            if li < 3:
                sd[f"{base}.{ci + 1}.weight"] = torch.tensor(
                    rng.uniform(0.5, 1.5, cout).astype(np.float32))
                sd[f"{base}.{ci + 1}.bias"] = torch.tensor(
                    (rng.randn(cout) * 0.1).astype(np.float32))
    return sd


def reference_track_state_dict(cfg, seed=0):
    """A composed tracking checkpoint's model state dict (the CoordNet
    under `npcs_net.`, the rotation net under `net.`, reference
    trainer.py:159-170), seeded from `seed`."""
    return {**reference_coordnet_sd(cfg, "npcs_net", seed),
            **reference_rotnet_sd(cfg, "net", seed + 1)}
