"""On-policy rollout fine-tuning: the port's `device_trajectory_batch`,
`collect_states`, `make_finetune_round` and `cli.rollout_finetune`
against the JAX package's (`captra_tpu/data/synthetic.py`,
`captra_tpu/training/rollout.py`), on the CPU at the sizes of
tests/test_rollout.py (T=5, B=2, N=128, a few-layer narrow net).

The JAX functions' keys become the port's explicit draws through
`tests/torch_port_helpers.py` (`jax_trajectory_draws`,
`jax_round_draws`).  Tolerances: trajectories 1e-6; the rollout's states
and errors 1e-4 (float32, the tracker's bar); a round in float64 in both
packages (the JAX one under `jax.enable_x64`) with SGD, losses within 1e-5
(relative to max(1, |loss|)) and every parameter leaf within 1e-4 of its
largest entry, BN statistics within 1e-5, as tests/test_torch_trainer.py
holds a train step.  Float32 train steps at these sizes are
ill-conditioned (tests/test_torch_trainer.py), and random nets amplify
1-ulp NPCS gaps in the s/t fit, so the NOCS head's last layer is scaled by
NOCS_GAIN in both packages (as tests/test_torch_otf.py does)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data import synthetic as jsyn
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.training import rollout as jrollout
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.cli import rollout_finetune as rollout_cli
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data import synthetic as tsyn
from captra_tpu_torch.training import checkpoint as tckpt
from captra_tpu_torch.training import rollout as trollout
from captra_tpu_torch.training import trainer as ttrainer
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, flax_variables, load_flax_variables, rotnet_from_flax,
)
from tests.torch_port_helpers import (
    jax_round_draws, jax_trajectory_draws, perturb, tiny_config, to_numpy,
    tree_leaves,
)

T, B, G, N = 5, 2, 4, 128
MINIBATCH = 4
NOCS_GAIN = 30.0
TRAJ_TOL = 1e-6
STATE_TOL = 1e-4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STAT_TOL = 1e-5
LR = 0.01


def _pool(obj_cfg):
    return tsyn.geometry_pool(seed=3, obj=obj_cfg, count=G, num_points=N)


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, got.dtype), rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_device_trajectory_batch_matches_jax(obj):
    jo = tiny_config(jschema, obj).obj
    to = tiny_config(tschema, obj).obj
    pool = _pool(to)
    geo = {k: v[:B] for k, v in pool.items()}
    key = jax.random.PRNGKey(11)
    want = jsyn.device_trajectory_batch(
        key, jnp.asarray(geo["npcs"]), jnp.asarray(geo["labels"]),
        jnp.asarray(geo["corners"]), jo, num_frames=T)
    got = tsyn.device_trajectory_batch(
        *map(torch.from_numpy, (geo["npcs"], geo["labels"],
                                geo["corners"])), to, num_frames=T,
        draws=jax_trajectory_draws(key, B, N, to.num_parts, T))
    assert got["points"].shape == (T, B, N, 3)
    for k in ("points", "nocs", "corners"):
        _close(got[k], want[k], TRAJ_TOL, k)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got["pose"], f), getattr(want["pose"], f), TRAJ_TOL,
               f)
    drawn = tsyn.device_trajectory_batch(
        *map(torch.from_numpy, (geo["npcs"], geo["labels"],
                                geo["corners"])), to, num_frames=T,
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["points"]).all()
    with pytest.raises(ValueError, match="draws"):
        tsyn.device_trajectory_batch(*map(torch.from_numpy, (
            geo["npcs"], geo["labels"], geo["corners"])), to, num_frames=T)


# ---------------------------------------------------------------------------
# nets shared by both packages
# ---------------------------------------------------------------------------

def _configs(schema, obj, net=None, norm="bn"):
    cfg = tiny_config(schema, obj, norm, num_points=N)
    if net is None:
        return cfg
    return cfg.replace(
        network=dataclasses.replace(cfg.network, type=net, pwm_num=32),
        optim=dataclasses.replace(cfg.optim, grad_clip=1.0,
                                  optimizer="sgd", learning_rate=LR))


def _variables(obj, norm="bn", seed=1):
    """Flax variables of the tiny CoordNet and RotNet from the JAX
    package's init, norm parameters and statistics perturbed, the NOCS
    head's last layer scaled by NOCS_GAIN."""
    cfg = _configs(jschema, obj, norm=norm)
    P = cfg.obj.num_parts
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    cv = perturb(to_numpy(JCoordNet(cfg).init(k1, jnp.zeros((1, N, 3)),
                                              train=False)), rng)
    head = cv["params"]["nocs_head"]["dense_1"]
    head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    rv = perturb(to_numpy(JRotNet(cfg).init(
        k2, jnp.zeros((1, P, N, 3)), jnp.zeros((1, N), jnp.int32),
        train=False)), rng)
    return cv, rv


def _track_inputs(obj):
    to = _configs(tschema, obj).obj
    pool = _pool(to)
    geo = {k: v[:B] for k, v in pool.items()}
    key = jax.random.PRNGKey(5)
    draws = jax_trajectory_draws(key, B, N, to.num_parts, T)
    return geo, key, draws


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_collect_states_matches_jax(obj):
    jcfg, tcfg = _configs(jschema, obj), _configs(tschema, obj)
    cv, rv = _variables(obj)
    geo, key, draws = _track_inputs(obj)
    jtraj = jsyn.device_trajectory_batch(
        key, *map(jnp.asarray, (geo["npcs"], geo["labels"],
                                geo["corners"])), jcfg.obj, num_frames=T)
    jinit = jtraj["pose"].map(lambda x: x[0])
    coord, rotn = JCoordNet(jcfg), JRotNet(jcfg)
    want, wanterr = jax.jit(lambda traj, ip: jrollout.collect_states(
        jcfg, lambda p: coord.apply(cv, p, train=False),
        lambda p, lab: rotn.apply(rv, p, lab, train=False), traj, ip))(
            jtraj, jinit)

    traj = tsyn.device_trajectory_batch(
        *map(torch.from_numpy, (geo["npcs"], geo["labels"],
                                geo["corners"])), tcfg.obj, num_frames=T,
        draws=draws)
    got, goterr = trollout.collect_states(
        tcfg, coordnet_from_flax(tcfg, cv, device="cpu").eval(),
        rotnet_from_flax(tcfg, rv, device="cpu").eval(), traj,
        traj["pose"][0], device="cpu")
    M = (T - 1) * B
    assert got["points"].shape == (M, N, 3)
    assert got["init_pose"].rotation.shape == (M, tcfg.obj.num_parts, 3, 3)
    for k in ("points", "nocs", "corners"):
        _close(got[k], want[k], STATE_TOL, k)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    for name in ("pose", "init_pose"):
        for f in ("rotation", "translation"):
            _close(getattr(got[name], f), getattr(want[name], f), STATE_TOL,
                   f"{name}.{f}")
        np.testing.assert_allclose(got[name].scale.numpy(),
                                   np.asarray(want[name].scale),
                                   rtol=STATE_TOL, err_msg=f"{name}.scale")
    # rows [0, B) are frame 1, whose carried pose is the init exactly
    torch.testing.assert_close(got["init_pose"].rotation[:B],
                               traj["pose"].rotation[0], rtol=0, atol=0)
    assert sorted(goterr) == sorted(wanterr)
    for k, v in goterr.items():
        assert v.dim() == 0
        tol = 1e-3 if k == "rdiff" else STATE_TOL   # degrees
        assert abs(float(v) - float(wanterr[k])) <= tol, k


# ---------------------------------------------------------------------------
# a fine-tune round
# ---------------------------------------------------------------------------

def _double(x):
    if isinstance(x, dict):
        return {k: _double(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_double(v) for v in x]
    if x is None:
        return None
    x = torch.as_tensor(x)
    return x.double() if x.is_floating_point() else x


def _as_f64(tree):
    def leaf(x):
        x = jnp.asarray(x)
        return x.astype(jnp.float64) if jnp.issubdtype(
            x.dtype, jnp.floating) else x
    return jax.tree.map(leaf, tree)


def _port_state(trainer, variables):
    module = load_flax_variables(
        trainer.net_cls(trainer.cfg, device="cpu"), variables).double()
    params, grads, layout = ttrainer.flatten_parameters(module)
    return ttrainer.TrainState(module=module, params=params, grads=grads,
                               opt_state=trainer.tx.init(params),
                               layout=layout)


def _jax_state(trainer, variables):
    params = _as_f64(variables["params"])
    return jtrainer.TrainState(
        params=params, batch_stats=_as_f64(variables["batch_stats"]),
        opt_state=trainer.tx.init(params), step=jnp.zeros((), jnp.int32))


ROUNDS = {"default": {}, "freeze_coord": {"freeze_coord": True},
          "plain_steps": {"plain_steps": 1}}
_ROUNDS = {}


def run_round(case):
    """One float64 round in each package from the same variables, draws
    and pool: ((JAX coord state, rot state, logs), (the port's))."""
    if case in _ROUNDS:
        return _ROUNDS[case]
    kw = ROUNDS[case]
    obj = "laptop"
    cv, rv = _variables(obj)
    tpool = _pool(_configs(tschema, obj).obj)
    key = jax.random.PRNGKey(21)
    sizes = dict(traj_batch=B, traj_frames=T, minibatch=MINIBATCH)
    jcfgs = {n: _configs(jschema, obj, n) for n in ("canon_coord", "rot")}
    tcfgs = {n: _configs(tschema, obj, n) for n in ("canon_coord", "rot")}
    jtr = {n: jtrainer.Trainer(c, steps_per_epoch=100)
           for n, c in jcfgs.items()}
    ttr = {n: ttrainer.Trainer(c, steps_per_epoch=100, device="cpu")
           for n, c in tcfgs.items()}
    with jax.enable_x64(True):
        jround = jrollout.make_finetune_round(
            _configs(jschema, obj), jtr["canon_coord"], jtr["rot"],
            _as_f64(tpool), **sizes, **kw)
        jc, jr, jlogs = jround(_jax_state(jtr["canon_coord"], cv),
                               _jax_state(jtr["rot"], rv), key)
        draws = jax_round_draws(key, tpool["labels"], tcfgs["canon_coord"],
                                tcfgs["rot"], _configs(tschema, obj),
                                **sizes, **kw)
        want = (jax.tree.map(np.asarray, jc.params),
                jax.tree.map(np.asarray, jc.batch_stats), int(jc.step),
                jax.tree.map(np.asarray, jr.params),
                jax.tree.map(np.asarray, jr.batch_stats), int(jr.step),
                {k: float(v) for k, v in jlogs.items()})
    tround = trollout.make_finetune_round(
        _configs(tschema, obj), ttr["canon_coord"], ttr["rot"],
        {k: _double(v) for k, v in tpool.items()}, **sizes, **kw,
        device="cpu")
    cs = _port_state(ttr["canon_coord"], cv)
    rs = _port_state(ttr["rot"], rv)
    cs, rs, logs = tround(cs, rs, draws=_double(draws))
    got = (flax_variables(cs.module)["params"],
           flax_variables(cs.module)["batch_stats"], cs.step,
           flax_variables(rs.module)["params"],
           flax_variables(rs.module)["batch_stats"], rs.step, logs)
    _ROUNDS[case] = (want, got, cv, rv)
    return _ROUNDS[case]


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_finetune_round_matches_jax(case):
    want, got, cv, rv = run_round(case)
    jcp, jcs, jcstep, jrp, jrs, jrstep, jlogs = want
    tcp, tcs, tcstep, trp, trs, trstep, logs = got
    n_train = (T - 1) * B // MINIBATCH + ROUNDS[case].get("plain_steps", 0)
    assert trstep == jrstep == n_train
    assert tcstep == jcstep == (0 if case == "freeze_coord" else n_train)
    assert sorted(logs) == sorted(jlogs)
    for k, v in logs.items():
        assert v.dim() == 0, k
        tol = LOSS_TOL * max(1.0, abs(jlogs[k]))
        if k == "rollout_rdiff":
            tol = 1e-3                                  # degrees
        assert abs(float(v) - jlogs[k]) <= tol, (k, float(v), jlogs[k])
    for name, t, j in (("coord", tcp, jcp), ("rot", trp, jrp)):
        for (path, a), (_, b) in zip(tree_leaves(t), tree_leaves(j)):
            scale = max(float(np.abs(b).max()), 1e-6)
            assert np.abs(a - b).max() <= PARAM_TOL * scale, (name, path)
    for name, t, j in (("coord", tcs, jcs), ("rot", trs, jrs)):
        for (path, a), (_, b) in zip(tree_leaves(t), tree_leaves(j)):
            np.testing.assert_allclose(a, b, rtol=0, atol=STAT_TOL,
                                       err_msg=f"{name} {path}")
    if case == "freeze_coord":
        for (path, a), (_, b) in zip(tree_leaves(tcp),
                                     tree_leaves(cv["params"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
        assert float(logs["coord_loss"]) == 0.0


def test_rollout_leaves_bn_statistics_alone():
    """The rollout runs the states' nets in eval mode without autograd:
    collecting the states moves no running statistic, and a round's train
    steps put the nets back in train mode."""
    obj = "laptop"
    cv, rv = _variables(obj)
    tcfgs = {n: _configs(tschema, obj, n) for n in ("canon_coord", "rot")}
    ttr = {n: ttrainer.Trainer(c, steps_per_epoch=100, device="cpu")
           for n, c in tcfgs.items()}
    cs = ttr["canon_coord"].init_state(variables=cv)
    rs = ttr["rot"].init_state(variables=rv)
    before = [flax_variables(s.module)["batch_stats"] for s in (cs, rs)]
    tround = trollout.make_finetune_round(
        _configs(tschema, obj), ttr["canon_coord"], ttr["rot"],
        _pool(tcfgs["rot"].obj), traj_batch=B, traj_frames=T,
        minibatch=MINIBATCH, device="cpu")
    draws = tround.draw(torch.Generator().manual_seed(0))
    seen = []
    real = trollout.collect_states

    def spy(*args, **kwargs):
        seen.append([m.training for m in (cs.module, rs.module)]
                    + [torch.is_grad_enabled()])
        out = real(*args, **kwargs)
        seen.append([flax_variables(s.module)["batch_stats"]
                     for s in (cs, rs)])
        return out

    trollout.collect_states = spy
    try:
        cs, rs, logs = tround(cs, rs, draws=draws)
    finally:
        trollout.collect_states = real
    assert seen[0] == [False, False, False]
    for b, a in zip(before, seen[1]):
        for (path, x), (_, y) in zip(tree_leaves(b), tree_leaves(a)):
            np.testing.assert_array_equal(x, y, err_msg=path)
    assert cs.module.training and rs.module.training
    after = flax_variables(rs.module)["batch_stats"]
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in
               zip(tree_leaves(before[1]), tree_leaves(after)))
    for v in logs.values():
        assert torch.isfinite(v) and v.dim() == 0
    with pytest.raises(ValueError, match="draws"):
        tround(cs, rs)


def test_round_draws_from_a_generator_are_reproducible():
    obj = "bottle"
    tcfgs = {n: _configs(tschema, obj, n) for n in ("canon_coord", "rot")}
    ttr = {n: ttrainer.Trainer(c, steps_per_epoch=100, device="cpu")
           for n, c in tcfgs.items()}
    tround = trollout.make_finetune_round(
        _configs(tschema, obj), ttr["canon_coord"], ttr["rot"],
        _pool(tcfgs["rot"].obj), traj_batch=B, traj_frames=T,
        minibatch=3, plain_steps=2, device="cpu")
    a = tround.draw(torch.Generator().manual_seed(3))
    b = tround.draw(torch.Generator().manual_seed(3))
    # 8 states in minibatches of 3: 2 minibatches, 2 states dropped
    assert len(a["train"]) == 2 and len(a["plain"]) == 2
    assert a["train"][1]["coord"]["pwm_idx"].shape == (3, 32)
    assert sorted(a["perm"].tolist()) == list(range((T - 1) * B))
    # the bottle's CoordNet samples its pairwise NOCS points; the rollout
    # states carry their init pose, so no pose noise
    assert sorted(a["train"][0]["coord"]) == ["pwm_idx"]
    assert a["train"][0]["rot"] == {}
    assert sorted(a["plain"][0]["rot"]) == ["noise"]

    def flat(x, path=""):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from flat(x[k], f"{path}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                yield from flat(v, f"{path}/{i}")
        elif x is not None:
            yield path, x

    for (p, x), (_, y) in zip(flat(a), flat(b)):
        assert torch.equal(x, y), p
    with pytest.raises(ValueError, match="minibatch"):
        trollout.make_finetune_round(
            _configs(tschema, obj), ttr["canon_coord"], ttr["rot"],
            _pool(tcfgs["rot"].obj), traj_batch=1, traj_frames=2,
            minibatch=2, device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _tiny_get_config(real):
    """`get_config` with the tiny net, 128 points and the bottle as given;
    everything else from the YAML."""
    tiny = tiny_config(tschema, num_points=N)

    def get_config(config, overrides=None, base_dir=None):
        cfg = real(config, overrides, base_dir)
        return cfg.replace(
            num_points=N, pointnet=tiny.pointnet,
            network=dataclasses.replace(cfg.network, backbone_out_dim=32,
                                        nocs_head_dims=(16,)))
    return get_config


def test_cli_writes_evidence_and_checkpoints(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(rollout_cli, "get_config",
                        _tiny_get_config(rollout_cli.get_config))
    cfg = rollout_cli.get_config("config_track.yml", {
        "obj_config": "obj_info_nocs.yml", "obj_category": "1",
        "network/norm": "gn"})
    gen = torch.Generator().manual_seed(0)
    paths = {}
    for name, net in (("coord", coordnet_from_flax), ("rot",
                                                      rotnet_from_flax)):
        module = (ttrainer.CoordNet if name == "coord" else
                  ttrainer.RotNet)(cfg, device="cpu", generator=gen)
        paths[name] = tckpt.save_checkpoint(
            str(tmp_path / name / "ckpt"), 0, flax_variables(module))
    out = tmp_path / "out"
    argv = ["--coord", paths["coord"], "--rot", paths["rot"], "--out",
            str(out), "--rounds", "2", "--eval_at", "1", "--traj_batch", "2",
            "--frames", "3", "--minibatch", "2", "--geom_pool", "4",
            "--eval_trajs", "2", "--eval_frames", "3", "--dtype", "float32",
            "--plain_steps", "1"]
    report = rollout_cli.main(argv, device="cpu")
    text = capsys.readouterr().out
    assert "# note: appending final budget 2" in text
    assert "round 1: coord_loss=" in text and "[eval @2]" in text
    with open(out / "EVIDENCE.json") as f:
        evidence = json.load(f)
    assert evidence == json.loads(json.dumps(report))
    assert sorted(evidence["trend"]) == ["0", "1", "2"]
    assert sorted(evidence["args"]) == sorted(
        k for k in vars(rollout_cli.parse(argv)) if k != "eval_budgets")
    for point in evidence["trend"].values():
        assert sorted(point) == ["frame1", "full"]
        assert sorted(point["full"]) == ["10deg10cm", "5deg5cm", "rdiff",
                                         "sdiff", "tdiff"]
        assert all(np.isfinite(v) for v in point["full"].values())
    # a round: (3 - 1) * 2 states in 2 minibatches, then 1 plain step
    for r in (1, 2):
        for net in ("canon_coord", "rot"):
            payload = tckpt.load_checkpoint(str(
                out / f"round_{r}" / net / "ckpt" / "model_0000"))
            assert payload["step"] == 3 * r, (r, net)
    with pytest.raises(SystemExit):
        rollout_cli.parse(argv[:6] + ["--rounds", "2", "--eval_at", "3"])
