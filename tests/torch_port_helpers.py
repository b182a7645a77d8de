"""Shared setup for the port's parity tests (tests/test_torch_*.py): the
same tiny configuration built from each package's own schema, numpy views of
flax variables, and seeded perturbations so converted norm statistics are
not identities."""
import contextlib

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


# ---------------------------------------------------------------------------
# a raw NOCS release, built pixel first (the JAX package's
# tests/test_preproc_pipeline.py::_write_frame, generalised)
# ---------------------------------------------------------------------------

# (instance number, class id, synset, name) of the raw release's objects
NOCS_RAW_INSTANCES = ((1, 1, "02876657", "bottle_red_stanford_norm"),
                      (2, 4, "02946921", "can_arizona_tea_norm"),
                      (3, 6, "03797390", "mug_brown_starbucks_norm"))
NOCS_SYN_K = np.array([[577.5, 0, 319.5], [0., 577.5, 239.5], [0., 0., 1.]])
NOCS_REAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084],
                        [0, 0, 1]])
NOCS_MODEL_HALF = (0.3, 0.4, 0.3)     # the .obj models' box, NPCS


def random_rotation(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2*y*y - 2*z*z, 2*x*y - 2*z*w, 2*x*z + 2*y*w],
        [2*x*y + 2*z*w, 1 - 2*x*x - 2*z*z, 2*y*z - 2*x*w],
        [2*x*z - 2*y*w, 2*y*z + 2*x*w, 1 - 2*x*x - 2*y*y]])


def write_raw_nocs(root, data_type, tracks, frames, block=(90, 60),
                   instances=NOCS_RAW_INSTANCES, seed=0, hw=(480, 640)):
    """Raw NOCS frames under <root>/nocs_full/<data_type>/<track>/ and an
    .obj model an instance under <root>/obj_models/, written with the
    port's `image_io.write_png`.  Each instance is a block of `block`
    pixels at about 1 m (a sloped surface with +-2 mm of per-pixel noise)
    in front of a background at 1.2 m, moving a pixel a frame down and
    right; every object pixel's camera point is the exact backprojection
    of its (row, col, depth), and its NOCS coord R^T (cam - t) / s
    quantized to the PNG's 8 bits, with t the block's centroid and a
    rotation and scale of the instance's own.  `real_*` types: 16-bit grey
    depth, coord z stored negated; CAMERA types (`train`, `val`): every
    image mirrored, the depth in 8-bit 3-channel composed form (G * 256 +
    R) as `_depth.png` and `_composed.png`.  Returns the fixture's poses
    {"<track>/<prefix>": {instance number: {rotation, scale,
    translation}}}."""
    import os
    from os.path import join as pjoin

    from captra_tpu_torch.data.image_io import write_png

    real = data_type.startswith("real")
    K = NOCS_REAL_K if real else NOCS_SYN_K
    H, W = hw
    bh, bw = block
    rng = np.random.RandomState(seed)
    obj = {n: (random_rotation(rng), 0.28 + 0.02 * k)
           for k, (n, *_) in enumerate(instances)}
    poses = {}
    for track in tracks:
        tdir = pjoin(root, "nocs_full", data_type, track)
        os.makedirs(tdir, exist_ok=True)
        for f in range(frames):
            prefix = f"{f:04d}"
            depth = (1200 + rng.randint(-2, 3, (H, W))).astype(np.uint16)
            mask = np.full((H, W), 255, np.uint8)
            coord = np.zeros((H, W, 3), np.uint8)
            frame = {}
            for k, (n, *_) in enumerate(instances):
                R, s = obj[n]
                r0 = H * 3 // 10 + f
                c0 = W * (3 + 10 * k) // 40 + f
                rr, cc = np.meshgrid(np.arange(r0, r0 + bh),
                                     np.arange(c0, c0 + bw), indexing="ij")
                d = (980 + 40 * k + (rr - r0) // 2 + (cc - c0) // 2
                     + rng.randint(-2, 3, rr.shape)).astype(np.uint16)
                depth[rr, cc] = d
                mask[rr, cc] = n
                dr = d.ravel().astype(np.float64)
                cam = np.stack([(cc.ravel() - K[0, 2]) / K[0, 0] * dr,
                                (H - rr.ravel() - K[1, 2]) / K[1, 1] * dr,
                                -dr], -1) * 0.001
                t = cam.mean(0)
                npcs = ((cam - t) / s) @ R               # R^T (cam - t) / s
                if np.abs(npcs).max() >= 0.5:
                    raise ValueError(f"instance {n} leaves the NPCS cube")
                if real:
                    npcs[:, 2] = -npcs[:, 2]
                q = np.clip(np.round((npcs + 0.5) * 255), 0, 255)
                coord[rr.ravel(), cc.ravel()] = q.astype(np.uint8)[:, ::-1]
                frame[n] = {"rotation": R, "scale": s,
                            "translation": t.reshape(3, 1)}
            poses[f"{track}/{prefix}"] = frame
            masks = np.stack([mask] * 3, -1)
            if real:
                images = {"depth": depth}
            else:
                composed = np.zeros((H, W, 3), np.uint8)
                composed[..., 1] = depth >> 8
                composed[..., 2] = depth & 255
                images = {"depth": composed, "composed": composed}
            images.update(mask=masks, coord=coord,
                          color=np.zeros((H, W, 3), np.uint8))
            for name, img in images.items():
                write_png(pjoin(tdir, f"{prefix}_{name}.png"),
                          img if real else img[:, ::-1])
            with open(pjoin(tdir, f"{prefix}_meta.txt"), "w") as fh:
                for n, cls, synset, name in instances:
                    print(f"{n} {cls} {name}" if real else
                          f"{n} {cls} {synset} {name}", file=fh)
    hx, hy, hz = NOCS_MODEL_HALF
    for n, cls, synset, name in instances:
        mdir = (pjoin(root, "obj_models", data_type) if real else
                pjoin(root, "obj_models", data_type, synset, name))
        os.makedirs(mdir, exist_ok=True)
        with open(pjoin(mdir, f"{name}.obj" if real else "model.obj"),
                  "w") as fh:
            fh.write(f"v {-hx} {-hy} {-hz}\nv {hx} {hy} {hz}\nf 1 2 1\n")
    return poses


def pose_errors(got: dict, want: dict) -> tuple:
    """(|scale diff|, max |translation diff|, rotation diff in degrees) of
    two similarity poses."""
    tr = np.trace(np.asarray(got["rotation"]).T @ want["rotation"])
    rdiff = np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))
    return (abs(float(got["scale"]) - want["scale"]),
            float(np.abs(np.asarray(got["translation"]).reshape(3)
                         - want["translation"].reshape(3)).max()),
            float(rdiff))


@contextlib.contextmanager
def one_torch_thread():
    """torch on one intra-op thread inside the block, restored after: where
    test processes share the cores, torch's default of a thread a core
    oversubscribes them and its small ops stall at their barriers."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# data-parallel ranks (tests/test_torch_parallel.py, tests/test_torch_cuda.py
# and chip_smoke.py start them with `parallel.mesh.launch`: this module
# imports numpy alone at the top, so a spawned rank imports no JAX)
# ---------------------------------------------------------------------------

def skew_batch(batch, num_parts: int):
    """A synthetic batch made a fair test of data parallelism: its halves
    get different BatchNorm statistics (the second half's clouds scaled by
    1.7 and moved by 0.2) and each row a different count of points in each
    part and out of every part (the last row wholly outside: no part-0
    point, so the symmetric NOCS loss's pairwise term skips it).  Plain
    DDP, with per-rank statistics and per-rank means, differs from the
    global-batch step on it.  Returns a new dict (points and labels as
    numpy)."""
    out = dict(batch)
    points = np.array(batch["points"], np.float32)
    labels = np.array(batch["labels"])
    B, N = labels.shape
    half = B // 2
    points[half:] = points[half:] * 1.7 + 0.2
    for b in range(B):
        cut = (N * b) // (2 * B) if b < B - 1 else N
        labels[b, :cut] = num_parts               # out of every part
        if num_parts > 1:
            labels[b, cut:cut + 3 * b] = 0        # part 0 grows with b
    out["points"], out["labels"] = points, labels
    return out


def as_float64(tree):
    """Every float tensor / array of a batch or draws tree (dicts, `Pose`s)
    as a float64 tensor; other leaves as tensors."""
    import torch
    if isinstance(tree, dict):
        return {k: as_float64(v) for k, v in tree.items()}
    if hasattr(tree, "map"):
        return tree.map(as_float64)
    x = torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree)
                        else tree)
    return x.double() if x.is_floating_point() else x


def f64_train_state(trainer, variables):
    """A port train state of flax `variables` in float64 (BN and GN then
    compute their statistics in float64 too), fresh moments."""
    from captra_tpu_torch.training import trainer as ttrainer
    from captra_tpu_torch.training.convert import load_flax_variables
    module = load_flax_variables(
        trainer.net_cls(trainer.cfg, device=trainer.device),
        variables).double()
    params, grads, layout = ttrainer.flatten_parameters(module)
    return ttrainer.TrainState(module=module, params=params, grads=grads,
                               opt_state=trainer.tx.init(params),
                               layout=layout)


def step_record(state, losses) -> dict:
    """What a train step is held to: its losses, the flat gradient, the
    flat parameters after it and the BN running statistics, as numpy."""
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": state.grads.detach().cpu().numpy().copy(),
            "params": state.params.detach().cpu().numpy().copy(),
            "stats": {k: v.detach().cpu().numpy().copy() for k, v in
                      state.module.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def dp_train_rank(rank, world, device, runs, hybrid=None):
    """One rank of float64 data-parallel runs: for each (config, variables,
    global batches, their global draws) of `runs`, the state of the
    variables and a step on the rank's shard of each batch with its shard
    of the draws; the group flat, or a (dcn, ici) grid.  Returns a list
    of `step_record`s a step, for each run."""
    import torch
    from captra_tpu_torch.parallel import mesh
    from captra_tpu_torch.training.trainer import Trainer
    dp = (mesh.data_parallel_mesh() if hybrid is None
          else mesh.hybrid_data_parallel_mesh(*hybrid))
    out = []
    for cfg, variables, batches, draws in runs:
        trainer = Trainer(cfg, steps_per_epoch=2, device=device, dp=dp)
        state = f64_train_state(trainer, variables)
        records = []
        for batch, dr in zip(batches, draws):
            state, losses, _ = trainer.train_step(
                state, mesh.shard_batch(as_float64(batch), rank, world),
                draws=mesh.shard_batch(as_float64(dr), rank, world))
            records.append(step_record(state, losses))
        assert torch.isfinite(state.params).all()
        out.append(records)
    return out


def dp_grid_rank(rank, world, device, runs):
    """`dp_train_rank` over the flat group, then the first run over a
    (2, world // 2) grid, and the messages of the grid's three
    ValueErrors (dcn not dividing the ranks, more groups than ranks,
    dcn * ici not the ranks)."""
    from captra_tpu_torch.parallel import mesh
    errors = []
    for dcn, ici in ((3, None), (2 * world, None), (2, 1)):
        try:
            mesh.hybrid_data_parallel_mesh(dcn, ici)
        except ValueError as e:
            errors.append(str(e))
    return {"flat": dp_train_rank(rank, world, device, runs),
            "grid": dp_train_rank(rank, world, device, runs[:1],
                                  hybrid=(2, world // 2)),
            "errors": errors}


def dp_orbax_rank(rank, world, device, cfg, variables, batch, draws,
                  ckpt_dir):
    """A data-parallel step, an orbax save by rank 0 alone, a barrier, and
    a restore on every rank into a fresh state: whether the restored
    parameters, moments, BN statistics and step equal the rank's own bit
    for bit, with the rank's parameters."""
    import torch
    from captra_tpu_torch.parallel import mesh
    from captra_tpu_torch.training import checkpoint as ckpt
    from captra_tpu_torch.training.trainer import Trainer
    dp = mesh.data_parallel_mesh()
    trainer = Trainer(cfg, steps_per_epoch=2, device=device, dp=dp)
    state = trainer.init_state(variables=variables)
    state, _, _ = trainer.train_step(
        state, mesh.shard_batch(batch, rank, world),
        draws=mesh.shard_batch(draws, rank, world))
    if rank == 0:
        ckpt.save_train_state(ckpt_dir, 0, state, format="orbax",
                              grad_clip=cfg.optim.grad_clip)
    dp.barrier()
    back = ckpt.restore_state(ckpt.load_checkpoint(
        ckpt.latest_checkpoint(ckpt_dir)), trainer.init_state())
    own, got = state.module.state_dict(), back.module.state_dict()
    return {"params": state.params.numpy().copy(),
            "equal": (torch.equal(back.params, state.params)
                      and all(torch.equal(back.opt_state[k],
                                          state.opt_state[k])
                              for k in ("mu", "nu"))
                      and back.opt_state["count"] == 1 and back.step == 1
                      and all(torch.equal(got[k], own[k]) for k in own))}


def dp_track_rank(rank, world, device):
    """`cli.track.track_sequences` over a batch of 3 and one of 2 synthetic
    trajectories of a tiny bottle (random nets), under a flat group when
    world > 1; returns its per-trajectory averages."""
    import contextlib
    import io
    import torch
    from captra_tpu_torch.cli.track import track_sequences
    from captra_tpu_torch.config import schema
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    from captra_tpu_torch.parallel import mesh
    from captra_tpu_torch.tracking.tracker import make_track_step
    cfg = tiny_config(schema, "bottle", num_points=64)
    g = torch.Generator().manual_seed(0)
    step = make_track_step(cfg, CoordNet(cfg, device=device, generator=g),
                           RotNet(cfg, device=device, generator=g),
                           device=device)
    seqs = []
    for seeds in ((0, 1, 2), (3, 4)):
        batch = batch_trajectories([make_trajectory(
            seed=s, obj=cfg.obj, num_frames=4, num_points=64)
            for s in seeds])
        seqs.append((tuple(f"t{s}" for s in seeds), batch))
    dp = mesh.data_parallel_mesh() if world > 1 else None
    with contextlib.redirect_stdout(io.StringIO()):
        return track_sequences(cfg, step, seqs, device=device, dp=dp)


def dp_cli_rank(rank, world, device, module, argv, *extra):
    """The rank body of a CLI (`<module>._rank_main`, what its `main`
    hands to `parallel.mesh.launch` at `--num_devices world`) on `argv`;
    returns what the rank printed."""
    import contextlib
    import importlib
    import io
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        importlib.import_module(module)._rank_main(rank, world, device,
                                                   argv, *extra)
    return text.getvalue()


def dp_card_rank(rank, world, device, steps):
    """`dp_card_steps` as one rank of a flat group (spawned by
    `parallel.mesh.launch`)."""
    from captra_tpu_torch.parallel import mesh
    return dp_card_steps(device, steps, mesh.data_parallel_mesh(), rank,
                         world)


def dp_card_steps(device, steps, dp=None, rank=0, world=1):
    """The full-width CoordNet laptop (batch 12 x 4096, float32, the
    seeded net; SGD: Adam's first update is +-lr on float32 noise, so
    float32 runs part by ~1e-3 of a loss from step 2 on) stepping under
    `dp` (None: one process) on this rank's
    shard of a fixed global batch with its shard of the global draws (a
    seeded CPU generator): step 1's losses and flat gradient, the FPS
    launches of each step, then the parameters and BN statistics after
    `steps` steps."""
    import torch
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.data.synthetic import make_frame_batch
    from captra_tpu_torch.ops import cuda_build, fps
    from captra_tpu_torch.parallel import mesh
    from captra_tpu_torch.training.trainer import Trainer
    import dataclasses
    cfg = get_config("config_coordnet.yml")
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, optimizer="sgd"))
    trainer = Trainer(cfg, 50, device=device, dp=dp)
    state = trainer.init_state(generator=torch.Generator().manual_seed(0))
    batch = make_frame_batch(0, cfg.obj, batch=cfg.batch_size,
                             num_points=cfg.num_points)
    gen = torch.Generator().manual_seed(1)
    out = {"launches": []}
    for s in range(steps):
        draws = mesh.shard_batch(Trainer(cfg, 50, device="cpu").draw(
            batch, gen), rank, world)
        draws = mesh.tree_map(lambda x: x.to(device), draws)
        local = mesh.shard_batch(batch, rank, world)
        cuda_build.reset_launch_counts()
        state, losses, _ = trainer.train_step(state, local, draws=draws)
        torch.cuda.synchronize()
        out["launches"].append({k: v for k, v in fps.launch_counts.items()
                                if v})
        if s == 0:
            out["losses"] = {k: float(v) for k, v in losses.items()}
            out["grads"] = state.grads.cpu().numpy()
    out["params"] = state.params.cpu().numpy()
    out["stats"] = {k: v.cpu().numpy() for k, v in
                    state.module.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    return out


def dp_jobs_rank(rank, world, device, jobs):
    """Several of this module's rank functions in one launch (starting the
    ranks costs more than most checks): {name: fn(rank, world, device,
    *args)} for each (name, function name, args) of `jobs`, in order."""
    return {name: globals()[fn](rank, world, device, *args)
            for name, fn, args in jobs}


def seeded_sa(sa_cfg, cf, seed, device="cpu", param_dtype=None, **kw):
    """An eval-mode port `SetAbstractionMsg` (keywords `kw` to its
    constructor) with xavier weights and biases, BatchNorm scales, shifts
    and running statistics drawn from `seed`, on `device`, its parameters
    cast to `param_dtype` where given."""
    import torch

    from captra_tpu_torch.models.backbone import SetAbstractionMsg
    from captra_tpu_torch.models.blocks import init_xavier_
    gen = torch.Generator().manual_seed(seed)
    m = init_xavier_(SetAbstractionMsg(sa_cfg, cf, **kw), generator=gen)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bias"):
                p.uniform_(-0.1, 0.1, generator=gen)
            elif "norm" in name:
                p.uniform_(0.8, 1.2, generator=gen)
        for name, b in m.named_buffers():
            if name.endswith("running_mean"):
                b.uniform_(-0.1, 0.1, generator=gen)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5, generator=gen)
    m = m.to(device)
    return (m if param_dtype is None else m.to(param_dtype)).eval()
