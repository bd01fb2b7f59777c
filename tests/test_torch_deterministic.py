"""Reproducible runs: under `torch.use_deterministic_algorithms(True)` two
seeded CPU Trainer runs (the hash grid and the fused MLP field, narrow
widths, 3 steps) are bit-equal, so the port's own Python adds no hidden
randomness; the encode and MLP wrappers on CPU tensors take their plain
versions in that mode and launch nothing, and their kernel entry points
refuse CPU tensors whichever variant is asked for."""
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


def test_fixed_order_scratch_sizes():
    """The index-gather variant's scratch: the maxima (16 bytes), then an
    int64 pair a table entry; the windowed variant's partial sums take 16
    bytes an entry where the atomic kernel's take 8."""
    assert the.fix_bytes((16, 1 << 19, 2)) == 16 + 16 * 16 * (1 << 19)
    assert the.fix_bytes((16, 1 << 12, 2)) == 16 + 16 * 16 * 4096
    rows = thw.level_scalars((4, 16, 45, 300), 1 << 19,
                             ((0, 0, 0, 3, 3, 3), (0, 0, 0, 14, 14, 14),
                              None, None))
    plan = thw.bwd_plan(rows, 262144, 1 << 19)
    assert plan.spans == (512, 4096, 0, 0)
    assert plan.dense == (0, 1) and plan.partial_entries == (
        plan.dense_parts * (512 + 4096))
