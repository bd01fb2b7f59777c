"""Reproducible runs: under `torch.use_deterministic_algorithms(True)` two
seeded CPU Trainer runs (the hash grid and the fused MLP field, narrow
widths, 3 steps) are bit-equal, so the port's own Python adds no hidden
randomness; the encode and MLP wrappers on CPU tensors take their plain
versions in that mode and launch nothing, and their kernel entry points
refuse CPU tensors whichever variant is asked for. With the launcher
replaced, the wrappers' choice of C entry and scratch is pinned on the CPU:
the windowed backward (#2) and the index-gather backward (#4 / #6) take
their fixed-order variants in deterministic mode only."""
import dataclasses

import numpy as np
import pytest
import torch

from spinnerf_tpu.data import llff, synthetic
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.ops import fused_mlp as tfm
from spinnerf_tpu_torch.ops import hash_encode as the
from spinnerf_tpu_torch.ops import hash_encode_win as thw
from spinnerf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"),
                             n_views=4, h=24, w=32, factor=1)
    sc = llff.load_scene(d, factor=1, prepare=True)
    return d, tllff.Scene(**{f.name: getattr(sc, f.name)
                             for f in dataclasses.fields(llff.Scene)})


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _cfg(tmp_path, datadir, tag, **kw):
    base = dict(expname=tag, basedir=str(tmp_path), datadir=str(datadir),
                factor=1, no_ndc=True, prepare=True, log2_hashmap_size=13,
                N_samples=8, N_importance=4, N_rand=32, lrate=1e-2,
                i_print=0, i_weights=0, i_video=0, i_testset=0, i_feat=0,
                compute_dtype="float32", llffhold=1000000, no_reload=True)
    base.update(kw)
    return Config(**base)


def _run(cfg, sc):
    tr = Trainer(cfg, scene=sc, device="cpu", log=lambda *a: None)
    metrics = [{k: float(v) for k, v in tr.fit(s, hooks=False).items()}
               for s in (1, 2, 3)]
    return metrics, [p.detach().clone() for p in tr.fields.parameters()]


@pytest.mark.parametrize("arm", ["hash", "mlp"])
def test_two_seeded_trainer_runs_are_bit_equal(scene, tmp_path, arm,
                                               deterministic):
    d, sc = scene
    kw = {} if arm == "hash" else dict(no_tcnn=True, netdepth=3,
                                       netwidth=32, netdepth_fine=3,
                                       netwidth_fine=32)
    (m1, p1), (m2, p2) = (_run(_cfg(tmp_path, d, f"{arm}{i}", **kw), sc)
                          for i in range(2))
    assert m1 == m2
    assert all(np.isfinite(v) for m in m1 for v in m.values())
    assert len(p1) == len(p2) and all(torch.equal(a, b)
                                      for a, b in zip(p1, p2))
    # the steps moved the parameters: the runs are equal, not idle
    tr = Trainer(_cfg(tmp_path, d, f"{arm}_init", **kw), scene=sc,
                 device="cpu", log=lambda *a: None)
    assert any(not torch.equal(a, b.detach())
               for a, b in zip(p1, tr.fields.parameters()))


def test_wrappers_take_plain_versions_on_cpu(deterministic):
    """In deterministic mode CPU tensors still take the plain versions: no
    kernel and no fixed-order variant is counted."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(64, 3).astype(np.float32))
    res = (4, 16, 45)
    tab = torch.from_numpy(rng.randn(3, 1 << 12, 2).astype(np.float32))
    tab.requires_grad_()
    thw.hash_encode_win_fused(tab, x, res).sum().backward()
    the.hash_encode_ngp_fused(tab, x, res).sum().backward()
    assert tab.grad is not None and torch.isfinite(tab.grad).all()
    assert not any(thw.launches.values()) and not any(
        thw.launches_det.values())
    assert not any(the.launches.values()) and not any(
        the.launches_det.values())
    assert tfm.launches == {"fwd": 0, "bwd": 0}


def test_kernel_entries_refuse_cpu_tensors_in_either_variant():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(64, 3).astype(np.float32))
    g = torch.zeros((64, 6))
    rows = thw.level_scalars((4, 16, 45), 1 << 12, None)
    work = torch.zeros(thw.bwd_plan(rows, 64, 1 << 12).work_ints,
                       dtype=torch.int32)
    for det in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            thw.hash_encode_win_bwd_kernel(g, x, work, rows, (3, 1 << 12, 2),
                                           deterministic=det)
        with pytest.raises(ValueError, match="CUDA"):
            the.hash_encode_ngp_bwd_kernel(g, x, (4, 16, 45),
                                           (3, 1 << 12, 2),
                                           deterministic=det)


_RES4 = (4, 16, 45, 300)
_BOXES4 = ((0, 0, 0, 3, 3, 3), (0, 0, 0, 14, 14, 14), None, None)


@pytest.mark.parametrize("log2_t,n", [(12, 262144), (19, 262144),
                                      (19, 666624), (25, 262144),
                                      (19, 1024), (19, 1025), (19, 0)])
def test_fixed_order_scratch_sizes(log2_t, n):
    """The windowed backward's scratch: partial sums of 8 bytes an entry
    (f32 pairs) in either kernel, and the fixed-order variant's `fix_bytes`
    = a flag and a count (16 bytes), then,
    where a segment can hold more than CHUNK_POINTS points, a slot index a
    split segment and a sorted id a point (each padded to 16 bytes) and an
    f32 page a paged level of each chunk of a split segment: at most
    ceil(N / 1024) + max_split chunks, since a segment of c > 1024 points
    has ceil(c / 1024) <= c / 1024 + 1. The index-gather variant's: the
    maxima (16 bytes), then an int64 pair a table entry."""
    t = 1 << log2_t
    assert the.fix_bytes((16, t, 2)) == 16 + 16 * 16 * t
    rows = thw.level_scalars(_RES4, t, _BOXES4 if log2_t >= 12 else None)
    plan = thw.bwd_plan(rows, n, t)
    n_seg = t // thw.CHUNK_POINTS
    max_split = min(n_seg, n // (thw.CHUNK_POINTS + 1))
    assert plan.max_split == max_split
    assert plan.spans == (512, 4096, 0, 0) and plan.paged == (2, 3)
    assert plan.partial_entries == plan.dense_parts * (512 + 4096)
    if not max_split:       # no segment can be split: the flag alone
        assert n <= thw.CHUNK_POINTS and plan.fix_bytes == 16
        assert plan.split_chunks == 0
        return
    chunks = -(-n // thw.CHUNK_POINTS) + max_split
    assert plan.split_chunks == chunks
    pad = lambda b: -(-b // 16) * 16        # noqa: E731
    assert plan.fix_bytes == (16 + pad(4 * max_split) + pad(4 * n)
                              + chunks * 2 * thw.PAGE_ENTRIES * 8)
    # the worst case the bound must hold: every split segment's chunks
    rng = np.random.RandomState(log2_t)
    counts = rng.multinomial(n, np.ones(n_seg) / n_seg)
    assert sum(-(-c // thw.CHUNK_POINTS) for c in counts
               if c > thw.CHUNK_POINTS) <= chunks


class _Launch(Exception):
    """Raised by the replaced launcher with what it was given."""


def _record(lib_name, *args):
    raise _Launch(lib_name, args)


@pytest.mark.parametrize("det", [None, False, True])
def test_windowed_backward_takes_its_variant_in_deterministic_mode(
        monkeypatch, det):
    """#2's wrapper launches `he_win_bwd_fix` with its plan and a scratch of
    `fix_bytes` where `deterministic` is True or, left None, where the mode
    is on, and the atomic `he_win_bwd` (no scratch) otherwise: the launcher
    replaced, the device check passed over, CPU tensors."""
    t, n = 1 << 12, 2500
    rows = thw.level_scalars(_RES4, t, _BOXES4)
    plan = thw.bwd_plan(rows, n, t)
    x = torch.rand(n, 3)
    g = torch.zeros((n, 8))
    work = torch.zeros(plan.work_ints, dtype=torch.int32)
    monkeypatch.setattr(thw, "_check", lambda *a: None)
    monkeypatch.setattr(thw, "_call", _record)
    assert plan.max_split == 2
    for mode in (False, True):
        torch.use_deterministic_algorithms(mode)
        try:
            with pytest.raises(_Launch) as got:
                thw.hash_encode_win_bwd_kernel(g, x, work, rows, (4, t, 2),
                                               deterministic=det)
        finally:
            torch.use_deterministic_algorithms(False)
        fixed = det if det is not None else mode
        name, args = got.value.args
        assert name == ("he_win_bwd_fix" if fixed else "he_win_bwd")
        dense = args[-4:-2] if fixed else args[-2:]
        assert dense == (plan.dense_parts, plan.wide_parts)
        assert len(args) == 15 + 2 * fixed   # the device, then 14 or 16
        if fixed:
            assert args[-1] == plan.fix_bytes
    assert thw.launches == {"fwd": 0, "bwd": 0}
    assert thw.launches_det == {"bwd": 0}


@pytest.mark.parametrize("det", [None, False, True])
def test_index_backward_takes_its_variant_in_deterministic_mode(
        monkeypatch, det):
    """#6's wrapper takes `hi_bwd_pts_fix` (scratch `fix_bytes`) where
    `deterministic` is True or, left None, where the mode is on, and
    `hi_bwd_pts` (a zeroed table) otherwise; the launcher replaced, the
    device check passed over."""
    res, t, n = (4, 16, 45), 1 << 12, 64
    x = torch.rand(n, 3)
    g = torch.zeros((n, 3, 2))
    calls = []
    monkeypatch.setattr(the, "_check_points", lambda *a: None)
    monkeypatch.setattr(the, "_call", lambda name, src, *a: calls.append(
        (name, a)))
    for mode in (False, True):
        torch.use_deterministic_algorithms(mode)
        try:
            d = the.hash_encode_ngp_bwd_kernel(g, x, res, (3, t, 2),
                                               deterministic=det)
        finally:
            torch.use_deterministic_algorithms(False)
        fixed = det if det is not None else mode
        name, args = calls[-1]
        assert name == ("hi_bwd_pts_fix" if fixed else "hi_bwd_pts")
        assert d.shape == (3, t, 2)
        if fixed:
            assert args[-1] == the.fix_bytes((3, t, 2))
        else:
            assert not d.any()           # the atomic kernel adds to zeros
    assert the.launches["bwd_pts"] + the.launches_det["bwd_pts"] == 2
    the.launches["bwd_pts"] = the.launches_det["bwd_pts"] = 0
