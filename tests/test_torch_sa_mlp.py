"""The fused set-abstraction scale (`captra_tpu_torch/ops/sa_mlp.py`) on the
CPU: its plain twins against the module chain they stand for (the factored
first layer's table and scale too), the module's route between them and
the rule that factors a scale, the kernel's shared-memory layout, the
tracer's counters and the benchmark's readers of them
(`sa_fused_share.track`, `sa_factored_share.track`).

The kernels themselves run only on the card (`tests/test_torch_cuda.py`)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from captra_tpu_torch import ops
from captra_tpu_torch.config.presets import nocs_bottle
from captra_tpu_torch.config.schema import SAMsgCfg
from captra_tpu_torch.models.backbone import scale_layers
from captra_tpu_torch.ops import cuda_build, sa_mlp
from captra_tpu_torch.utils import profiling
from torch_port_helpers import seeded_sa

PN = nocs_bottle().pointnet


def _cloud(B, N, cf, seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy(rng.rand(B, N, 3) - 0.5).to(dtype)
    feats = None if cf == 0 else torch.from_numpy(
        np.abs(rng.randn(B, N, cf))).to(dtype)
    return xyz, feats


def _small(sa_cfg, npoint):
    return SAMsgCfg(npoint=npoint, radius_list=sa_cfg.radius_list,
                    nsample_list=tuple(min(k, 16)
                                       for k in sa_cfg.nsample_list),
                    mlp_list=sa_cfg.mlp_list)


# the five scales of pointnet2_camera at their published widths: sa1's
# three with features xyz (C_in 6) and none (C_in 3), sa2's two (C_in 323,
# the second with its 196-wide hidden layer)
LAYOUTS = [("sa1", i, cf) for i in range(3) for cf in (3, 0)] + [
    ("sa2", i, 320) for i in range(2)]


@pytest.mark.parametrize("stage,scale,cf", LAYOUTS)
def test_twin_equals_the_chain_in_float64(stage, scale, cf):
    sa_cfg = _small(PN.sa1 if stage == "sa1" else PN.sa2, 8)
    m = seeded_sa(sa_cfg, cf, scale + cf, param_dtype=torch.float64)
    xyz, feats = _cloud(2, 64, cf, seed=scale, dtype=torch.float64)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(xyz.float(), 8))
    radius, k = sa_cfg.radius_list[scale], sa_cfg.nsample_list[scale]
    mlp = getattr(m, f"scale_{scale}")
    idx = ops.ball_query(radius, k, xyz, new_xyz)
    with torch.no_grad():
        got = sa_mlp.sa_mlp_plain(xyz, new_xyz, feats, idx, scale_layers(mlp))
        want = torch.amax(mlp(ops.ball_group(radius, k, xyz, new_xyz, feats)),
                          dim=2)
    assert got.dtype == torch.float64
    assert got.shape == (2, 8, sa_cfg.mlp_list[scale][-1])
    assert torch.equal(got, want)


def _spy(monkeypatch):
    calls = []
    real = sa_mlp.sa_scale

    def spy(*args, **kwargs):
        calls.append(args[3].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(sa_mlp, "sa_scale", spy)
    return calls


@pytest.mark.parametrize("case", ["train", "gn", "bf16", "grad"])
def test_the_route_keeps_the_chain(case, monkeypatch):
    sa_cfg = _small(PN.sa1, 8)
    m = seeded_sa(sa_cfg, 3, 0, norm="gn" if case == "gn" else "bn",
                  dtype=torch.bfloat16 if case == "bf16" else None)
    if case == "train":
        m.train()
    xyz, feats = _cloud(2, 64, 3)
    calls = _spy(monkeypatch)
    with torch.set_grad_enabled(case == "grad"):
        assert not m.fused(xyz, feats)
        new_xyz, out = m(xyz, feats)
    assert calls == [] and out.shape == (2, 8, m.out_dim)


@pytest.mark.parametrize("stage,cf", [("sa1", 3), ("sa1", 0), ("sa2", 320)])
def test_eval_bn_float32_takes_the_twin_on_the_cpu(stage, cf, monkeypatch):
    sa_cfg = _small(PN.sa1 if stage == "sa1" else PN.sa2, 8)
    m = seeded_sa(sa_cfg, cf, 0)
    xyz, feats = _cloud(2, 64, cf, seed=1)
    calls = _spy(monkeypatch)
    with torch.no_grad():
        assert m.fused(xyz, feats)
        _, got = m(xyz, feats)
    assert len(calls) == len(sa_cfg.nsample_list)
    _, want = m(xyz, feats)          # grad enabled: the module chain
    assert torch.equal(got, want)


def test_a_strided_cloud_takes_the_twin_as_the_chain():
    # CoordNet's cloud arrives as a [B, N, 3] view of [B, 3, N]; the fused
    # route hands the ball query that view, as the chain does (on the card
    # the layout steers the distance product's rounding: the card tests
    # hold the module and the tracking step to the chain there)
    sa_cfg = _small(PN.sa1, 16)
    m = seeded_sa(sa_cfg, 3, 3)
    planes = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 96)
                              .astype(np.float32) - 0.5)
    xyz = planes.transpose(1, 2)
    assert not xyz.is_contiguous()
    with torch.no_grad():
        _, got = m(xyz, xyz)
    _, want = m(xyz, xyz)
    assert torch.equal(got, want)


def test_the_layout_takes_every_configured_scale():
    for sa in (PN.sa1, PN.sa2):
        for k, dims in zip(sa.nsample_list, sa.mlp_list):
            cpt, x, y, nbytes = sa_mlp.layout(k, dims)
            assert cpt * k <= sa_mlp.ROWS and cpt >= 1
            assert x % 4 == 0 and y % 4 == 0 and y >= sa_mlp.STAGE_FLOATS
            assert nbytes <= sa_mlp.SMEM_LIMIT
            assert sa_mlp.fits(k, dims)
    # sa2's second scale: its 196-wide layer padded to 208 channel rows
    assert sa_mlp.layout(128, (128, 196, 256))[2] == 208 * sa_mlp.STRIDE


@pytest.mark.parametrize("K,dims", [(129, (32,)), (32, (8,) * 4),
                                    (64, (1024, 1024, 64)), (0, (32,))])
def test_the_kernel_refuses_what_it_cannot_hold(K, dims):
    assert not sa_mlp.fits(K, dims)


def test_a_scale_beyond_the_kernel_takes_the_route(monkeypatch):
    # the route has no shape condition: a scale the kernel cannot hold
    # takes the twin on the CPU, and on the card the kernel's wrapper
    # raises (tests/test_torch_cuda.py)
    sa_cfg = SAMsgCfg(npoint=4, radius_list=(0.5,), nsample_list=(160,),
                      mlp_list=((8, 16),))
    m = seeded_sa(sa_cfg, 0, 0)
    xyz, _ = _cloud(1, 200, 0)
    assert not sa_mlp.fits(160, (8, 16))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        assert m.fused(xyz, None)
        _, got = m(xyz, None)
    assert calls == [(1, 4, 160)]
    assert torch.equal(got, m(xyz, None)[1])


def test_the_kernel_wrapper_takes_only_cuda_tensors():
    m = seeded_sa(_small(PN.sa1, 4), 0, 0)
    xyz, _ = _cloud(1, 32, 0)
    new_xyz = xyz[:, :4].contiguous()
    idx = torch.zeros(1, 4, 8, dtype=torch.int64)
    out = torch.empty(1, 4, m.out_dim)
    with pytest.raises(ValueError, match="CUDA"):
        sa_mlp.sa_mlp_cuda(xyz, new_xyz, None, idx, scale_layers(m.scale_0),
                           out)
    with pytest.raises(ValueError, match="no fused"):
        sa_mlp.sa_scale(xyz.to("meta"), new_xyz, None, idx,
                        scale_layers(m.scale_0), out)


@pytest.mark.parametrize("grad", [False, True])
def test_the_tracer_counts_fused_scales(grad):
    sa_cfg = _small(PN.sa1, 8)
    m = seeded_sa(sa_cfg, 3, 0)
    xyz, feats = _cloud(2, 64, 3)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.set_grad_enabled(grad), profiling.annotate("track.step"):
            with profiling.annotate("track.coordnet"):
                m(xyz, feats)
    root = profiling.last_steps("track.step", 1)[0]
    counters = root["children"][0]["counters"]
    profiling.reset()
    # the scales are counted by the backbone on either route; `sa_fused`
    # counts kernel launches only, so the CPU twin counts none
    assert counters.get("sa_scales") == len(sa_cfg.nsample_list)
    assert counters.get("sa_fused", 0) == 0


def _span(name, children=(), **counters):
    return {"name": name, "step": 0, "host_ms": 1.0, "device_ms": 1.0,
            "counters": counters, "children": list(children)}


@pytest.mark.parametrize("store,want", [
    # two traced steps, CoordNet's and RotNet's scales below each root
    ([_span("track.step", [_span("track.coordnet", sa_scales=5, sa_fused=5),
                           _span("track.rotnet", sa_scales=5, sa_fused=5)])
      ] * 2, 1.0),
    ([_span("track.step", [_span("track.coordnet", sa_scales=5, sa_fused=5),
                           _span("track.rotnet", sa_scales=5)])] * 2, 0.5),
    # a program that counts no scale: nothing to read
    ([_span("track.step", [_span("track.coordnet")])] * 2, None),
])
def test_the_share_reader(store, want, monkeypatch):
    from port_bench.harness import metric_reader
    monkeypatch.setattr(profiling, "last_steps",
                        lambda root, n: [r for r in store
                                         if r["name"] == root][-n:])
    read = metric_reader("sa_fused_share.track")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=2))) == want
    assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiling, "last_steps")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=2))) is None


# ---------------------------------------------------------------------------
# the factored first layer: the per-point table and the scale that starts
# from it
# ---------------------------------------------------------------------------

# every configured scale with the points its stage reads: sa1 over the
# 4096-point cloud (features xyz or none), sa2 over sa1's 512 centres and
# their 320 channels
ROUTES = [("sa1", i, cf, 4096) for i in range(3) for cf in (3, 0)] + [
    ("sa2", i, 320, PN.sa1.npoint) for i in range(2)]


@pytest.mark.parametrize("stage,scale,cf,N", ROUTES)
def test_the_rule_factors_sa2_and_gathers_sa1(stage, scale, cf, N):
    sa = PN.sa1 if stage == "sa1" else PN.sa2
    got = sa_mlp.factored(N, sa.npoint, sa.nsample_list[scale], cf)
    assert got == (stage == "sa2")


@pytest.mark.parametrize("N,S,K,cf,want", [
    (512, 128, 4, 320, False),      # as many rows as points
    (512, 128, 5, 320, True),       # just above
    (512, 128, 64, 15, False),      # features narrower than a chunk
    (512, 128, 64, 16, True),
])
def test_the_rule_at_its_edges(N, S, K, cf, want):
    assert sa_mlp.factored(N, S, K, cf) is want


def _layers64(mlp):
    return [sa_mlp.Layer(*(t.detach().double() for t in L[:6]), L.eps)
            for L in scale_layers(mlp)]


# sa2's two scales at their published widths (the second, 196 wide in the
# middle), the table of that scale alone or of both (the second's columns
# after the first's); ragged: features not a multiple of a chunk, one layer
FACTORED = [(PN.sa2, 320, i, both) for i in range(2) for both in (False, True)
            ] + [(SAMsgCfg(npoint=8, radius_list=(0.4, 0.6),
                           nsample_list=(16, 9), mlp_list=((40, 24), (7,))),
                  20, i, True) for i in range(2)]


@pytest.mark.parametrize("sa_cfg,cf,scale,both", FACTORED)
def test_the_factored_twin_equals_the_chain_in_float64(sa_cfg, cf, scale,
                                                       both):
    sa_cfg = _small(sa_cfg, 8)
    m = seeded_sa(sa_cfg, cf, 7 + scale, param_dtype=torch.float64)
    xyz, feats = _cloud(2, 64, cf, seed=scale, dtype=torch.float64)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(xyz.float(), 8))
    idx = ops.ball_query(sa_cfg.radius_list[scale],
                         sa_cfg.nsample_list[scale], xyz, new_xyz)
    layers = [_layers64(getattr(m, f"scale_{i}"))
              for i in range(len(sa_cfg.nsample_list))]
    picked = range(len(layers)) if both else [scale]
    table = sa_mlp.sa_table_plain(feats, [layers[i][0].weight
                                          for i in picked])
    offset = sum(layers[i][0].weight.shape[0] for i in picked if i < scale)
    with torch.no_grad():
        got = sa_mlp.sa_mlp_factored_plain(xyz, new_xyz, idx, table, offset,
                                           layers[scale])
        want = sa_mlp.sa_mlp_plain(xyz, new_xyz, feats, idx, layers[scale])
    assert got.dtype == torch.float64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_the_table_twin_is_each_scale_s_feature_products():
    m = seeded_sa(_small(PN.sa2, 8), 320, 3)
    _, feats = _cloud(2, 40, 320)
    weights = [getattr(m, f"scale_{i}").dense_0.weight for i in range(2)]
    with torch.no_grad():
        got = sa_mlp.sa_table_plain(feats, weights)
    assert got.shape == (2, 40, 256)
    for i, w in enumerate(weights):
        want = feats.double() @ w[:, :320].detach().double().T
        torch.testing.assert_close(got[..., 128 * i:128 * (i + 1)].double(),
                                   want, rtol=1e-5, atol=1e-5)


def test_the_table_kernel_takes_only_cuda_tensors():
    feats = torch.ones(1, 8, 20)
    with pytest.raises(ValueError, match="CUDA"):
        sa_mlp.sa_table_cuda(feats, [torch.ones(16, 23)])


@pytest.mark.parametrize("case", ["train", "gn", "bf16", "grad", "cpu"])
def test_only_the_kernels_route_builds_a_table(case, monkeypatch):
    # training, GroupNorm, bfloat16 and autograd keep the module chain, and
    # the CPU twin keeps today's arithmetic: none of them factors sa2
    m = seeded_sa(_small(PN.sa2, 8), 320, 0,
                  norm="gn" if case == "gn" else "bn",
                  dtype=torch.bfloat16 if case == "bf16" else None)
    if case == "train":
        m.train()
    xyz, feats = _cloud(2, 64, 320)
    tables = []
    monkeypatch.setattr(sa_mlp, "sa_table_cuda",
                        lambda *a: tables.append(a))
    with torch.set_grad_enabled(case == "grad"):
        assert m.fused(xyz, feats) is (case == "cpu")
        _, out = m(xyz, feats)
    assert tables == [] and out.shape == (2, 8, m.out_dim)


def _on_a_stand_in_card(monkeypatch):
    """The kernels' route on the CPU: `takes_kernel` says yes, operands
    pass unchecked and a launch only counts (its outputs are not
    written)."""
    monkeypatch.setattr(cuda_build, "takes_kernel", lambda *t: True)
    monkeypatch.setattr(cuda_build, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(
        sa_mlp._KERNELS, "launch", lambda kernel, device, *args:
        cuda_build.count(kernel, sa_mlp._KERNELS.counters.get(kernel)))


@pytest.mark.parametrize("stage,cf", [("sa1", 3), ("sa1", 0), ("sa2", 320)])
@pytest.mark.parametrize("card", [False, True])
def test_the_tracer_counts_factored_scales(stage, cf, card, monkeypatch):
    # the kernels' route counts `sa_factored` once a factored scale, at its
    # launch, and launches one table a stage; the CPU twin counts none
    sa_cfg = PN.sa1 if stage == "sa1" else PN.sa2
    sa_cfg = SAMsgCfg(npoint=32 if stage == "sa1" else 8,
                      radius_list=sa_cfg.radius_list,
                      nsample_list=sa_cfg.nsample_list,
                      mlp_list=sa_cfg.mlp_list)
    m = seeded_sa(sa_cfg, cf, 0)
    xyz, feats = _cloud(1, 160, cf)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(
        xyz, sa_cfg.npoint))
    idxs = [ops.ball_query(r, k, xyz, new_xyz)
            for r, k in zip(sa_cfg.radius_list, sa_cfg.nsample_list)]
    if card:
        _on_a_stand_in_card(monkeypatch)
    cuda_build.reset_launch_counts()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad(), profiling.annotate("track.step"):
            m._fused_scales(xyz, new_xyz, feats, idxs)
    counters = profiling.last_steps("track.step", 1)[0]["counters"]
    profiling.reset()
    scales = len(sa_cfg.nsample_list)
    factored = scales if card and stage == "sa2" else 0
    assert counters.get("sa_fused", 0) == (scales if card else 0)
    assert counters.get("sa_factored", 0) == factored
    assert sa_mlp.launch_counts["sa_table_cuda"] == int(factored > 0)
    assert sa_mlp.launch_counts["sa_mlp_cuda"] == (scales if card else 0)
    cuda_build.reset_launch_counts()


@pytest.mark.parametrize("store,want", [
    # two traced steps, CoordNet's and RotNet's: sa2's 2 scales of 5
    ([_span("track.step", [
        _span("track.coordnet", sa_scales=5, sa_fused=5, sa_factored=2),
        _span("track.rotnet", sa_scales=5, sa_fused=5, sa_factored=2)])
      ] * 2, 0.4),
    ([_span("track.step", [
        _span("track.coordnet", sa_scales=5, sa_fused=5, sa_factored=2),
        _span("track.rotnet", sa_scales=5, sa_fused=5)])] * 2, 0.2),
    # a program without the factored route (no `sa_factored`), or one
    # that counts no scale: nothing to read
    ([_span("track.step", [_span("track.coordnet", sa_scales=5,
                                 sa_fused=5)])] * 2, None),
    ([_span("track.step", [_span("track.coordnet")])] * 2, None),
])
def test_the_factored_share_reader(store, want, monkeypatch):
    from port_bench.harness import metric_reader
    monkeypatch.setattr(profiling, "last_steps",
                        lambda root, n: [r for r in store
                                         if r["name"] == root][-n:])
    read = metric_reader("sa_factored_share.track")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=2))) == want
    assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiling, "last_steps")
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=2))) is None
