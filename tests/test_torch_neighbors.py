"""A backbone stage's neighbour search (`captra_tpu_torch/ops/neighbors.py`)
on the CPU: its plain twins against the chain the kernels replaced
(`pointops.ball_query` a radius, `pointops.three_nn`) bit for bit, the
route between kernel and twin, the tracer's `nbr_stages` /
`nbr_fused` counters and `backbone.neighbors` spans, and the benchmark's
readers of them (`neighbors_span_ms.track`, `nbr_fused_share.track`).

The kernels themselves run only on the card (`tests/test_torch_cuda.py`)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from captra_tpu_torch.config.presets import nocs_bottle
from captra_tpu_torch.models.backbone import PointNet2Msg, SetAbstractionMsg
from captra_tpu_torch.ops import cuda_build, neighbors, pointops
from captra_tpu_torch.utils import profiling
from torch_port_helpers import tiny_config

PN = nocs_bottle().pointnet


def _cloud(B, N, seed, scale=0.6, strided=False):
    """B clouds of N points in a box of side `scale`; `strided`: a
    [B, N, 3] view of [B, 3, N] (CoordNet's cloud)."""
    rng = np.random.RandomState(seed)
    planes = torch.from_numpy(((rng.rand(B, 3, N) - 0.5) * scale)
                              .astype(np.float32))
    xyz = planes.transpose(1, 2)
    return xyz if strided else xyz.contiguous()


def _centres(xyz, S):
    return pointops.gather_xyz(xyz, pointops.farthest_point_sample(
        xyz.contiguous(), S))


def _chain(radii, nsamples, xyz, new_xyz):
    return [pointops.ball_query(r, k, xyz, new_xyz)
            for r, k in zip(radii, nsamples)]


def _equal_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == w.shape
        assert torch.equal(g, w)


# every radius of a stage at once against each radius alone: the
# published stages (sa1 at 4096 and 1001 points, sa2 at 512), N past no
# tile of 128 nor of 4, a strided cloud
@pytest.mark.parametrize("stage,B,N,S,strided", [
    ("sa1", 2, 4096, 512, False),
    ("sa1", 2, 4096, 512, True),
    ("sa1", 3, 1001, 64, True),
    ("sa2", 4, 512, 128, False),
    ("sa2", 2, 130, 16, False),
    ("sa2", 1, 7, 3, False),
])
def test_every_radius_at_once_equals_each_alone(stage, B, N, S, strided):
    cfg = PN.sa1 if stage == "sa1" else PN.sa2
    nsamples = [min(k, N) for k in cfg.nsample_list]
    xyz = _cloud(B, N, seed=N + B, strided=strided)
    new_xyz = _centres(xyz, S)
    got = neighbors.ball_query_stage(cfg.radius_list, nsamples, xyz, new_xyz)
    _equal_lists(got, _chain(cfg.radius_list, nsamples, xyz, new_xyz))
    terms = pointops.distance_terms(new_xyz, xyz)
    _equal_lists(neighbors.ball_query_plain(*terms, cfg.radius_list,
                                            nsamples), got)


def test_a_point_exactly_at_the_radius_is_inside():
    # exact arithmetic: centre 0.5 e_x, points at 1.0 e_x (d = 0.25 = r^2)
    # and just beyond it; the hit is kept, the rest pad with it
    xyz = torch.tensor([[[1.0, 0.0, 0.0], [1.0 + 2 ** -20, 0.0, 0.0],
                         [0.0, 3.0, 0.0], [1.0, 0.0, 0.0]]])
    new_xyz = torch.tensor([[[0.5, 0.0, 0.0]]])
    d = pointops.square_distance(new_xyz, xyz)
    assert float(d[0, 0, 0]) == 0.25 == pointops._f32_square(0.5)
    got = neighbors.ball_query_stage((0.5, 0.4999), (3, 2), xyz, new_xyz)
    assert got[0].tolist() == [[[0, 3, 0]]]
    assert got[1].tolist() == [[[0, 0]]]
    _equal_lists(got, _chain((0.5, 0.4999), (3, 2), xyz, new_xyz))


@pytest.mark.parametrize("case", ["empty", "fewer_than_k"])
def test_empty_balls_and_few_hits(case):
    xyz = _cloud(2, 300, seed=3)
    if case == "empty":
        new_xyz = xyz[:, :5] + 10.0          # far from every point
    else:
        new_xyz = xyz[:, :5].clone()         # each centre hits itself
    radii, nsamples = (0.01, 0.05), (16, 32)
    got = neighbors.ball_query_stage(radii, nsamples, xyz, new_xyz)
    _equal_lists(got, _chain(radii, nsamples, xyz, new_xyz))
    if case == "empty":
        assert all(bool((g == 0).all()) for g in got)
    else:
        first = got[0][..., :1]
        assert bool((first[:, :, 0] == torch.arange(5)).all())
        # the slots past a centre's hits repeat its first hit
        hits = (pointops.square_distance(new_xyz, xyz)
                <= pointops._f32_square(0.01)).sum(-1)
        assert int(hits.max()) < 16
        slot = torch.arange(16)
        assert bool(torch.where(slot >= hits[..., None], got[0] == first,
                                True).all())


@pytest.mark.parametrize("B,N,M,strided", [
    (2, 4096, 512, True),        # fp1 (CoordNet's strided cloud)
    (2, 512, 128, False),        # fp2
    (3, 301, 130, False),        # ragged
    (2, 40, 2, False),           # fewer than three points
    (2, 40, 1, False),
])
def test_three_nn_twin_equals_the_chain(B, N, M, strided):
    xyz1 = _cloud(B, N, seed=N, strided=strided)
    xyz2 = _centres(xyz1, M)
    got = neighbors.three_nn_stage(xyz1, xyz2)
    want = pointops.three_nn(xyz1, xyz2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    twin = neighbors.three_nn_plain(*pointops.distance_terms(xyz1, xyz2))
    for g, w in zip(twin, want):
        assert torch.equal(g, w)


def test_three_nn_ties_take_the_lowest_index():
    # every coarse point twice, on a grid: equal distances everywhere
    g = torch.arange(4, dtype=torch.float32) * 0.25
    coarse = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1
                         ).reshape(1, -1, 3)
    coarse = torch.cat([coarse, coarse], 1)            # 128 points, 64 twins
    fine = coarse[:, :64] + torch.tensor([0.125, 0.0, 0.0])
    d, i = neighbors.three_nn_stage(fine, coarse)
    want_d, want_i = pointops.three_nn(fine, coarse)
    assert torch.equal(i, want_i) and torch.equal(d, want_d)
    # halfway between grid points: four at the nearest distance (a point,
    # its twin 64 on, its neighbour 16 on in x and that one's twin), taken
    # lowest index first
    inner = (fine[0, :, 0] < 0.75)
    assert bool((d[0, inner] == d[0, inner, :1]).all())
    assert bool((i[0, inner] == i[0, inner, :1] + torch.tensor(
        [0, 16, 64])).all())
    tied = d[..., 1:] == d[..., :-1]
    assert bool(torch.where(tied, i[..., 1:] > i[..., :-1], True).all())


def _spy(monkeypatch):
    calls = []
    for name in ("ball_query_plain", "three_nn_plain", "ball_query_cuda",
                 "three_nn_cuda"):
        real = getattr(neighbors, name)

        def spy(*args, _name=name, _real=real):
            calls.append(_name)
            return _real(*args)
        monkeypatch.setattr(neighbors, name, spy)
    return calls


# everything but a float32 CUDA cloud that takes no gradient takes the twin
@pytest.mark.parametrize("case", ["cpu", "grad", "bf16", "float64", "meta"])
def test_the_route(case, monkeypatch):
    xyz = _cloud(2, 64, seed=5)
    new_xyz = xyz[:, :8].clone()
    if case == "grad":
        xyz.requires_grad_(True)
    elif case in ("bf16", "float64"):
        dtype = torch.bfloat16 if case == "bf16" else torch.float64
        xyz, new_xyz = xyz.to(dtype), new_xyz.to(dtype)
    elif case == "meta":
        xyz, new_xyz = xyz.to("meta"), new_xyz.to("meta")
    assert not cuda_build.takes_kernel(xyz, new_xyz)
    if case == "meta":
        return
    calls = _spy(monkeypatch)
    with torch.enable_grad():
        got = neighbors.ball_query_stage((0.1, 0.2), (4, 8), xyz, new_xyz)
        d, i = neighbors.three_nn_stage(xyz, new_xyz)
        want_d, want_i = pointops.three_nn(xyz, new_xyz)
    assert calls == ["ball_query_plain", "three_nn_plain"]
    _equal_lists(got, _chain((0.1, 0.2), (4, 8), xyz, new_xyz))
    assert torch.equal(i, want_i) and torch.equal(d, want_d)
    # a cloud that takes a gradient keeps it through the twin's distances,
    # as through the chain's
    assert d.requires_grad == want_d.requires_grad == (case == "grad")


def test_the_kernel_wrappers_take_only_cuda_tensors():
    xyz = _cloud(1, 32, seed=6)
    terms = pointops.distance_terms(xyz[:, :4].contiguous(), xyz)
    with pytest.raises(ValueError, match="CUDA"):
        neighbors.ball_query_cuda(*terms, (0.1,), (4,))
    with pytest.raises(ValueError, match="CUDA"):
        neighbors.three_nn_cuda(*terms)


def _traced(net, xyz, grad_mode, requires_grad):
    profiling.reset()
    xyz = xyz.clone().requires_grad_(requires_grad)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with torch.set_grad_enabled(grad_mode), \
                profiling.annotate("track.step"):
            with profiling.annotate("track.coordnet"):
                net(xyz)
    root = profiling.last_steps("track.step", 1)[0]
    profiling.reset()
    return root["children"][0]


def _standing_in(kernel, twin):
    def launch(*args):
        cuda_build.count(kernel, neighbors._KERNELS.counter)
        return twin(*args)
    return launch


@pytest.mark.parametrize("grad_mode,requires_grad,on_card", [
    (False, False, False),      # tracking: no_grad
    (True, False, False),       # training: the cloud takes no gradient
    (True, True, False),        # a cloud that takes one
    (False, False, True),       # the kernel's route, its twin standing in
    (True, False, True),
])
def test_the_tracer_counts_and_spans_the_stages(grad_mode, requires_grad,
                                                 on_card, monkeypatch):
    from captra_tpu_torch.config import schema
    if on_card:
        # every input takes the kernel's route (the SA scales the chain);
        # each kernel's twin stands in, its launch counted by the seam
        # under the counter the module registered
        monkeypatch.setattr(cuda_build, "takes_kernel", lambda *t: True)
        monkeypatch.setattr(SetAbstractionMsg, "fused",
                            lambda self, xyz, feats: False)
        for kernel, twin in (("ball_query_cuda", neighbors.ball_query_plain),
                             ("three_nn_cuda", neighbors.three_nn_plain)):
            monkeypatch.setattr(neighbors, kernel, _standing_in(kernel, twin))
    cfg = tiny_config(schema)
    net = PointNet2Msg(cfg.pointnet, 16, use_xyz_feat=True).eval()
    span = _traced(net, _cloud(2, 128, seed=7), grad_mode, requires_grad)
    stages = span["children"]
    # sa1, sa2, fp2, fp1 (fp3 broadcasts its one coarse point)
    assert [s["name"] for s in stages] == ["backbone.neighbors"] * 4
    for s in stages:
        assert s["children"] == []
        # every stage counted; the kernel's stages also as fused (on the
        # CPU every stage takes the twin)
        assert s["counters"] == ({"nbr_stages": 1, "nbr_fused": 1}
                                 if on_card else {"nbr_stages": 1})


def _span(name, children=(), device_ms=1.0, **counters):
    return {"name": name, "step": 0, "host_ms": 1.0, "device_ms": device_ms,
            "counters": counters, "children": list(children)}


def _net(name, stages, fused):
    return _span(name, [_span("backbone.neighbors", device_ms=0.25,
                              nbr_stages=1, nbr_fused=int(i < fused))
                        for i in range(stages)], device_ms=5.0)


@pytest.mark.parametrize("store,want_ms,want_share", [
    # two traced steps, four stages a net, every stage fused
    ([_span("track.step", [_net("track.coordnet", 4, 4),
                           _net("track.rotnet", 4, 4),
                           _span("track.fit")])] * 2, 2.0, 1.0),
    # RotNet's stages through the chain
    ([_span("track.step", [_net("track.coordnet", 4, 4),
                           _net("track.rotnet", 4, 0)])] * 2, 2.0, 0.5),
    # a program with neither span nor counters: nothing to read
    ([_span("track.step", [_span("track.coordnet")])] * 2, None, None),
])
def test_the_readers(store, want_ms, want_share, monkeypatch):
    from port_bench.harness import metric_reader
    monkeypatch.setattr(profiling, "last_steps",
                        lambda root, n: [r for r in store
                                         if r["name"] == root][-n:])
    run = SimpleNamespace(trace=SimpleNamespace(steps=2))
    for name, want in (("neighbors_span_ms.track", want_ms),
                       ("nbr_fused_share.track", want_share)):
        read = metric_reader(name)
        assert read(run) == want, name
        assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiling, "last_steps")
    for name in ("neighbors_span_ms.track", "nbr_fused_share.track"):
        assert metric_reader(name)(run) is None
