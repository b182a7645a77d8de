"""Data parallelism in the port (`captra_tpu_torch/parallel/`, the trainer,
BatchNorm and the losses under a group, the CLIs' `--num_devices`) on the
CPU: gloo ranks started by `mesh.launch` (spawned processes, a `file://`
rendezvous under the run's temporary directory; the ranks import no JAX).

The semantics are GSPMD's (tests/test_parallel.py:21-55): a step over W
ranks is the single-device step on the global batch.  Bars:

- the port's float64 step at W = 2 and W = 4 against its single-process
  step on the global batch: losses within 1e-10 (relative to max(1,
  |loss|)), gradient, parameter and BN-statistic leaves within 1e-9 of
  their largest entry (floored at 1e-3 of the net's largest: biases that
  feed a train-mode BN have gradients of float noise), for 3 SGD steps of
  a CoordNet (symmetric bottle) and a RotNet (laptop); parameters and
  statistics equal bit for bit on every rank.  The batches are skewed
  (`skew_batch`: halves with different statistics, rows with different
  part counts), and plain DDP's result (the mean of the per-shard
  single-process gradients) must miss the gradient bar by more than 100x;
- the port at W = 2 against the JAX package's mesh step under
  `jax.enable_x64`, at the trainer tests' bars (losses 1e-5, leaves
  1e-4);
- a (2, 2) grid of groups at the same bars as the flat group, and its
  ValueErrors;
- an orbax save by rank 0, a barrier, a bit-equal restore on every rank;
- the track, train and finetune CLIs at `--num_devices 2` (what `main`
  hands to `mesh.launch`, run in the shared launch) writing the pickles,
  err.csv, checkpoints and logs of a one-rank run;
  `dryrun_multichip(4, device="cpu")` printing its ok line.

One launch of two ranks serves every W = 2 check (`two_ranks`): starting
ranks costs seconds, more than most checks."""
import io
import contextlib
import os
import pickle
from os.path import join as pjoin

import jax
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import make_frame_batch as jmake_frame_batch
from captra_tpu.parallel.mesh import data_parallel_mesh, replicate
from captra_tpu.parallel.mesh import shard_batch as jshard_batch
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.cli import evaluate as evaluate_cli
from captra_tpu_torch.cli import track as track_cli
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data.synthetic import make_frame_batch
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.parallel.dryrun import dryrun_multichip
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.convert import flat_tree, flax_variables
from captra_tpu_torch.training.trainer import Trainer
from tests.test_torch_train_cli import (  # noqa: F401 - a fixture
    _nocs_argv, _nocs_root, config_dir,
)
from tests.test_torch_trainer import (
    _as_f64, _jax_state, _jax_step, _variables, train_config,
)
from tests.torch_port_helpers import (
    as_float64, dp_grid_rank, dp_jobs_rank, dp_track_rank,
    f64_train_state, jax_train_draws, one_torch_thread, skew_batch,
    step_record, to_numpy, tree_leaves,
)

B, N = 4, 64
STEPS = 3
LOSS_TOL, LEAF_TOL = 1e-10, 1e-9
JAX_LOSS_TOL, JAX_LEAF_TOL = 1e-5, 1e-4
CLI_TOL = 1e-4          # float32 CLIs: one rank against two
CASES = [("canon_coord", "bottle", "bn"), ("rot", "laptop", "bn")]
TIMEOUT = 240


def _run(net, obj, norm, optimizer="sgd"):
    """The trainer, variables, skewed global batches and their global
    draws of a case, and its single-process float64 steps (records) with
    their state."""
    cfg = train_config(tschema, net, obj, norm, optimizer).replace(
        num_points=N)
    trainer = Trainer(cfg, steps_per_epoch=2, device="cpu")
    variables = _variables(trainer, 1)
    batches = [skew_batch(make_frame_batch(s, cfg.obj, batch=B,
                                           num_points=N), cfg.obj.num_parts)
               for s in range(STEPS)]
    draws = [trainer.draw(b, torch.Generator().manual_seed(100 + s))
             for s, b in enumerate(batches)]
    state = f64_train_state(trainer, variables)
    ref = []
    for batch, dr in zip(batches, draws):
        state, losses, _ = trainer.train_step(state, as_float64(batch),
                                              draws=as_float64(dr))
        ref.append(step_record(state, losses))
    return dict(cfg=cfg, trainer=trainer, variables=variables,
                batches=batches, draws=draws, ref=ref, state=state)


def _leaf_error(got: np.ndarray, want: np.ndarray, layout) -> float:
    """The largest distance of a flat buffer's leaves to the reference's,
    each relative to the reference leaf's largest entry (floored at 1e-3
    of the whole buffer's)."""
    floor = 1e-3 * np.abs(want).max()
    worst = 0.0
    for _, o, shape in layout:
        n = int(np.prod(shape))
        w, g = want[o:o + n], got[o:o + n]
        worst = max(worst, np.abs(g - w).max() / max(np.abs(w).max(),
                                                     floor))
    return worst


def _assert_steps_close(got, ref, layout, loss_tol, leaf_tol):
    for s, (g, r) in enumerate(zip(got, ref)):
        for k, v in r["losses"].items():
            assert abs(g["losses"][k] - v) <= loss_tol * max(1.0, abs(v)), \
                (s, k, g["losses"][k], v)
        for field in ("grads", "params"):
            err = _leaf_error(g[field], r[field], layout)
            assert err <= leaf_tol, (s, field, err)
        for k, v in r["stats"].items():
            scale = max(np.abs(v).max(), 1e-3)
            assert np.abs(g["stats"][k] - v).max() <= leaf_tol * scale, \
                (s, k)


def _assert_ranks_equal(results):
    last = [r[-1] for r in results]
    for other in last[1:]:
        np.testing.assert_array_equal(other["params"], last[0]["params"])
        for k, v in last[0]["stats"].items():
            np.testing.assert_array_equal(other["stats"][k], v, err_msg=k)


def _naive_ddp_error(run, world) -> float:
    """Plain DDP's first step (per-rank statistics and means, the mean of
    the per-shard gradients) measured as `_leaf_error` against the global
    step."""
    trainer, grads = run["trainer"], []
    for rank in range(world):
        state = f64_train_state(trainer, run["variables"])
        with one_torch_thread():
            state, _, _ = trainer.train_step(
                state, mesh.shard_batch(as_float64(run["batches"][0]), rank,
                                        world),
                draws=mesh.shard_batch(as_float64(run["draws"][0]), rank,
                                       world))
        grads.append(state.grads.numpy().copy())
    return _leaf_error(np.mean(grads, axis=0), run["ref"][0]["grads"],
                       run["state"].layout)


def _jax_case():
    """The symmetric CoordNet's config (both schemas), variables, skewed
    batch (port and JAX) and the JAX step's key and draws."""
    net, obj, norm = CASES[0]
    jcfg = train_config(jschema, net, obj, norm).replace(num_points=N)
    tcfg = train_config(tschema, net, obj, norm).replace(num_points=N)
    variables = _variables(Trainer(tcfg, steps_per_epoch=2, device="cpu"), 3)
    batch = skew_batch(make_frame_batch(0, tcfg.obj, batch=B, num_points=N),
                       tcfg.obj.num_parts)
    key = jax.random.PRNGKey(100)
    with jax.enable_x64(True):
        jbatch = _as_f64(skew_batch(jmake_frame_batch(
            0, jcfg.obj, batch=B, num_points=N), jcfg.obj.num_parts))
        draws = jax_train_draws(tcfg, key, jbatch["labels"])
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch,
                jbatch=jbatch, key=key, draws=draws)


@pytest.fixture(scope="module")
def runs():
    """Both cases' single-process float64 steps (`_run`), shared by the
    W = 2 and W = 4 checks."""
    return [_run(*case) for case in CASES]


def _track_argv(config_dir, exp, coord, *extra):
    return ["--config_dir", config_dir, "--experiment_dir", exp,
            "--coord_exp/dir", coord, "--obj_config", "obj_info_nocs.yml",
            "--obj_category", "1", "--pointnet_cfg/camera",
            "pointnet2_tiny.yml", "--num_points", str(N),
            "--network/backbone_out_dim", "32", "--synthetic_data",
            "--init_frame/gt", "false", "--save", *extra]


def _track_cli_setup(config_dir, base):
    """The seeded tiny nets of the track CLI test written as a coord
    experiment and two rot experiments ("one", "two"), and each run's
    argv (`--batch_size 2`; "two" at `--num_devices 2`)."""
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    coord = str(base / "coord")
    _, cfg = track_cli.parse(_track_argv(config_dir, coord, coord))
    g = torch.Generator().manual_seed(0)
    ckpt.save_checkpoint(pjoin(coord, "ckpt"), 0, flax_variables(
        CoordNet(cfg, device="cpu", generator=g)))
    rot = flax_variables(RotNet(cfg, device="cpu", generator=g))
    argv = {}
    for name, extra in (("one", []), ("two", ["--num_devices", "2"])):
        exp = str(base / name)
        ckpt.save_checkpoint(pjoin(exp, "ckpt"), 0, rot)
        argv[name] = _track_argv(config_dir, exp, coord, "--batch_size",
                                 "2", *extra)
    return argv


def _train_cli_setup(config_dir, base, cli):
    """The NOCS fixture tree of the train or finetune CLI test and each
    run's argv (SGD; "two" at `--num_devices 2`)."""
    modes = (("train", "val", "real_test") if cli == "train"
             else ("train", "real_train", "real_test"))
    root = _nocs_root(base, modes)
    extra = ["--use_val", "val"] if cli == "train" else ["--syn_n", "1"]
    return {name: _nocs_argv(config_dir, root, str(base / name),
                             "--optimizer", "SGD", *extra, *ranks)
            for name, ranks in (("one", []),
                                ("two", ["--num_devices", "2"]))}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, runs, config_dir):
    """One launch of two gloo ranks for every W = 2 check of this file
    (starting ranks costs more than most checks): both nets' float64
    steps, the JAX comparison's step, the orbax save and restore,
    `track_sequences` over a batch of 3 and one of 2, and the rank bodies
    of the track, train and finetune CLIs at `--num_devices 2` (what their
    `main` hands to `mesh.launch`)."""
    jcase = _jax_case()
    orbax_cfg = train_config(tschema, "rot", "laptop", "bn", "adam").replace(
        num_points=N)
    trainer = Trainer(orbax_cfg, steps_per_epoch=2, device="cpu")
    orbax_vars = _variables(trainer, 1)
    orbax_batch = skew_batch(make_frame_batch(0, orbax_cfg.obj, batch=B,
                                              num_points=N), 2)
    orbax_draws = trainer.draw(orbax_batch,
                               torch.Generator().manual_seed(7))
    orbax_dir = str(tmp_path_factory.mktemp("orbax") / "ckpt")
    clis = {"track": _track_cli_setup(config_dir,
                                      tmp_path_factory.mktemp("track"))}
    for cli in ("train", "finetune"):
        clis[cli] = _train_cli_setup(config_dir,
                                     tmp_path_factory.mktemp(cli), cli)
    args, cfg = track_cli.parse(clis["track"]["two"])
    cv, rv = track_cli.load_variables(cfg, args)
    jobs = [
        ("steps", "dp_train_rank", ([(r["cfg"], r["variables"],
                                      r["batches"], r["draws"])
                                     for r in runs],)),
        ("jax", "dp_train_rank", ([(jcase["tcfg"], jcase["variables"],
                                    [jcase["batch"]], [jcase["draws"]])],)),
        ("orbax", "dp_orbax_rank", (orbax_cfg, orbax_vars, orbax_batch,
                                    orbax_draws, orbax_dir)),
        ("track", "dp_track_rank", ()),
        ("track_cli", "dp_cli_rank", ("captra_tpu_torch.cli.track",
                                      clis["track"]["two"], cv, rv)),
        ("train_cli", "dp_cli_rank", ("captra_tpu_torch.cli.train",
                                      clis["train"]["two"])),
        ("finetune_cli", "dp_cli_rank", ("captra_tpu_torch.cli.finetune",
                                         clis["finetune"]["two"])),
    ]
    results = mesh.launch(dp_jobs_rank, 2, "cpu", args=(jobs,),
                          timeout=TIMEOUT)
    return dict(runs=runs, jax=jcase, orbax_dir=orbax_dir, clis=clis,
                results=results)


def _experiment(argv):
    return argv[argv.index("--experiment_dir") + 1]


def _launched_argv(monkeypatch, module, argv, result=None):
    """What `module.main(argv)` hands to `mesh.launch` (which is not
    started): (function, ranks, device, args)."""
    seen = []

    def launch(fn, world, device=None, args=()):
        seen.append((fn, world, device, args))
        return [result]
    monkeypatch.setattr(mesh, "launch", launch)
    module.main(argv, device="cpu")
    (call,) = seen
    return call


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_step_as_the_global_batch(world, runs, request):
    """W ranks against one process on the global batch, for both nets;
    at W = 4 also the (2, 2) grid (the CoordNet) and its ValueErrors.
    Plain DDP misses the bar by more than 100x on the same batches (W =
    2)."""
    if world == 2:
        shared = request.getfixturevalue("two_ranks")
        groups = {"flat": [r["steps"] for r in shared["results"]]}
    else:
        results = mesh.launch(dp_grid_rank, world, "cpu", args=([
            (run["cfg"], run["variables"], run["batches"], run["draws"])
            for run in runs],), timeout=TIMEOUT)
        errors = results[0]["errors"]
        assert "dcn=3 must divide the world size (4)" in errors[0]
        assert "dcn=8 must divide" in errors[1]
        assert "dcn*ici = 2*1 != world size 4" in errors[2]
        groups = {"flat": [r["flat"] for r in results],
                  "grid": [r["grid"] for r in results]}
    for i, run in enumerate(runs):
        for ranks in groups.values():
            if i >= len(ranks[0]):       # the grid runs the first case
                continue
            for res in ranks:
                _assert_steps_close(res[i], run["ref"], run["state"].layout,
                                    LOSS_TOL, LEAF_TOL)
            _assert_ranks_equal([res[i] for res in ranks])
        if world == 2:
            assert _naive_ddp_error(run, world) > 100 * LEAF_TOL


def test_two_ranks_match_the_jax_mesh_step(two_ranks):
    """The symmetric CoordNet's step at W = 2 against the JAX step over a
    2-device mesh (the batch sharded, the state replicated: GSPMD), both in
    float64, from the same variables, skewed batch and draws."""
    c = two_ranks["jax"]
    jt = jtrainer.Trainer(c["jcfg"], steps_per_epoch=2)
    step = _jax_step(jt)
    with jax.enable_x64(True):
        jmesh = data_parallel_mesh(2, devices=jax.devices()[:2])
        xstate = replicate(_jax_state(jt, _as_f64(c["variables"])), jmesh)
        xstate, xl, _, xg = step(xstate, jshard_batch(c["jbatch"], jmesh),
                                 c["key"])
        xl = {k: float(v) for k, v in xl.items()}
        xg, xstats = to_numpy(xg), to_numpy(xstate.batch_stats)
    results = [r["jax"][0] for r in two_ranks["results"]]
    tt = Trainer(c["tcfg"], steps_per_epoch=2, device="cpu")
    state = f64_train_state(tt, c["variables"])
    for res in results:
        got = res[0]
        for k, v in xl.items():
            assert abs(got["losses"][k] - v) <= JAX_LOSS_TOL * max(
                1.0, abs(v)), (k, got["losses"][k], v)
        grads = dict(tree_leaves(flat_tree(state, torch.from_numpy(
            got["grads"]))))
        want = dict(tree_leaves(xg))
        big = max(np.abs(v).max() for v in want.values())
        for k, v in want.items():
            scale = max(np.abs(v).max(), 1e-3 * big)
            assert np.abs(grads[k] - v).max() <= JAX_LEAF_TOL * scale, k
        state.module.load_state_dict(
            {k: torch.from_numpy(v) for k, v in got["stats"].items()},
            strict=False)
        stats = dict(tree_leaves(flax_variables(state.module)[
            "batch_stats"]))
        for k, v in tree_leaves(xstats):
            np.testing.assert_allclose(stats[k], v, rtol=0,
                                       atol=JAX_LOSS_TOL * max(
                                           1.0, np.abs(v).max()))
    _assert_ranks_equal([[r[0]] for r in results])


def test_orbax_save_on_rank_zero_restores_on_every_rank(two_ranks):
    """The counterpart of tests/test_parallel.py's
    test_multiprocess_orbax_checkpoint: rank 0 writes, every rank reads
    its own state back bit for bit."""
    got = [r["orbax"] for r in two_ranks["results"]]
    assert [r["equal"] for r in got] == [True, True]
    np.testing.assert_array_equal(got[0]["params"], got[1]["params"])
    assert os.listdir(two_ranks["orbax_dir"]) == ["model_0000"]


def test_track_cli_on_two_ranks_writes_what_one_writes(two_ranks,
                                                       monkeypatch, capfd):
    """`--num_devices 2 --batch_size 2`: `main` hands its argv and nets to
    two ranks; there both batches of 2 trajectories are sharded, one a
    rank, the frame-0 noise drawn for the whole batch first.  The result
    pickles and the evaluator's err.csv equal a one-rank run's, and rank
    0 alone prints."""
    argv = two_ranks["clis"]["track"]
    with one_torch_thread():
        track_cli.main(argv["one"], device="cpu")
    texts = {"one": capfd.readouterr().out}
    ranks = [r["track_cli"] for r in two_ranks["results"]]
    texts["two"] = ranks[0]
    assert ranks[1] == ""
    fn, world, device, args = _launched_argv(monkeypatch, track_cli,
                                             argv["two"], result={})
    assert (fn, world, device) == (track_cli._rank_main, 2,
                                   torch.device("cpu"))
    assert args[0] == argv["two"]
    for name in ("one", "two"):
        with contextlib.redirect_stdout(io.StringIO()), one_torch_thread():
            evaluate_cli.main(argv[name] + ["--no_iou"], device="cpu")
    for name, text in texts.items():
        assert text.count("TOTAL: 76 frames") == 1, (name, text)
        assert text.count("synthetic/0000|synthetic/0001: 19 frames x 2") \
            == 1, (name, text)
    avg = [ln for ln in texts["one"].splitlines() if ln.startswith("AVG")]
    assert avg and avg[0] in texts["two"]
    exps = {name: _experiment(a) for name, a in argv.items()}
    data = sorted(os.listdir(pjoin(exps["one"], "results", "data")))
    assert data == sorted(os.listdir(pjoin(exps["two"], "results",
                                           "data"))) and len(data) == 4
    for f in data:
        with open(pjoin(exps["one"], "results", "data", f), "rb") as h:
            want = pickle.load(h)
        with open(pjoin(exps["two"], "results", "data", f), "rb") as h:
            got = pickle.load(h)
        for part in ("pred", "gt"):
            for k, v in want[part]["poses"].items():
                np.testing.assert_array_equal(got[part]["poses"][k], v)
            np.testing.assert_array_equal(got[part]["corners"],
                                          want[part]["corners"])
        assert got["frame_nums"] == want["frame_nums"]
    csv = [open(pjoin(exps[n], "results", "err.csv")).read()
           for n in ("one", "two")]
    assert csv[0] == csv[1] and csv[0].count("\n") >= 4


def test_track_batches_the_ranks_do_not_divide_stay_on_rank_zero(
        two_ranks):
    """A batch of 3 over 2 ranks is tracked by rank 0 alone, as the JAX
    CLI leaves it unsharded; a batch of 2 is sharded."""
    got = [r["track"] for r in two_ranks["results"]]
    assert got[1] == {}
    with one_torch_thread():
        want = dp_track_rank(0, 1, "cpu")
    assert sorted(got[0]) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[0][k], want[k])


@pytest.mark.parametrize("cli", ["train", "finetune"])
def test_train_clis_on_two_ranks(two_ranks, monkeypatch, cli):
    """The train and finetune CLIs at `--num_devices 2` on the NOCS
    fixtures (SGD, the symmetric bottle: pairwise NOCS sample and BN
    statistics global): `main` hands its argv to two ranks; there rank 0
    alone logs and writes, and its checkpoint and logged losses are a
    one-rank run's, within float32's reordering of the sums."""
    from captra_tpu_torch.cli import finetune as finetune_cli
    from captra_tpu_torch.cli import train as train_cli
    module = train_cli if cli == "train" else finetune_cli
    argv = two_ranks["clis"][cli]
    with one_torch_thread():
        module.main(argv["one"], device="cpu")
    assert [r[f"{cli}_cli"] for r in two_ranks["results"]] == ["", ""]
    fn, world, device, args = _launched_argv(monkeypatch, module,
                                             argv["two"])
    assert (fn, world, device, args) == (module._rank_main, 2,
                                         torch.device("cpu"),
                                         (argv["two"],))
    logs, trees = {}, {}
    for name in ("one", "two"):
        exp = _experiment(argv[name])
        logs[name] = open(pjoin(exp, "log", "log.txt")).read()
        trees[name] = ckpt.load_checkpoint(pjoin(exp, "ckpt", "model_0000"))
    assert "data parallel: 2 ranks" in logs["two"]
    assert trees["one"]["step"] == trees["two"]["step"] > 0
    for name in ("params", "batch_stats"):
        want = dict(tree_leaves(trees["one"][name]))
        for k, v in tree_leaves(trees["two"][name]):
            scale = max(np.abs(want[k]).max(), 1e-3)
            assert np.abs(v - want[k]).max() <= CLI_TOL * scale, (name, k)
    lines = [ln.split(" - ")[-1] for ln in logs["two"].splitlines()
             if " epoch 0 " in ln and " is " in ln]
    want = {ln.split(" - ")[-1].rsplit(" is ", 1)[0]:
            float(ln.rsplit(" is ", 1)[1]) for ln in
            logs["one"].splitlines() if " epoch 0 " in ln and " is " in ln}
    assert len(lines) == len(want) > 0      # each line once: rank 0 alone
    for ln in lines:
        k, v = ln.rsplit(" is ", 1)
        assert abs(float(v) - want[k]) <= CLI_TOL * max(1.0, abs(want[k])), k


def test_dryrun_multichip_four_ranks(capfd):
    loss = dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert f"dryrun_multichip(4): ok, loss={loss:.4f}" in out
    assert np.isfinite(loss)


def test_shard_and_gather_batch():
    """`shard_batch` is the JAX function's slice (leaves without the batch
    axis replicated; a batch the ranks do not divide raises), and the
    shards concatenate back to the batch (what `gather_batch` does over
    the ranks); `active` scopes the group that BatchNorm and the losses
    see."""
    from captra_tpu_torch.pose.part_dof import Pose
    x = torch.arange(24.0).reshape(2, 6, 2)
    pose = Pose(rotation=torch.zeros(6, 1, 3, 3),
                translation=torch.zeros(6, 1, 3, 1), scale=torch.arange(6.0))
    tree = {"x": x, "key": torch.arange(2)}
    parts = [mesh.shard_batch(tree, r, 3, batch_dim=1) for r in range(3)]
    assert torch.equal(parts[1]["x"], x[:, 2:4])
    assert torch.equal(parts[2]["key"], tree["key"])   # [T]: replicated
    tree = {"pose": pose, "n": np.arange(12).reshape(6, 2)}
    rows = [mesh.shard_batch(tree, r, 3) for r in range(3)]
    assert torch.equal(rows[2]["pose"].scale, torch.tensor([4.0, 5.0]))
    np.testing.assert_array_equal(rows[0]["n"], tree["n"][:2])
    assert torch.equal(torch.cat([p["x"] for p in parts], 1), x)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        mesh.shard_batch({"n": tree["n"]}, 0, 4)
    assert mesh.current() is None
    with mesh.active(mesh.DataParallel(rank=0, world=1)) as dp:
        assert mesh.current() is dp
    assert mesh.current() is None
