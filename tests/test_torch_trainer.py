"""The port's Trainer on the CPU at a small size: it trains, pins the same
hash-index sidecar as the JAX Trainer, checkpoints round-trip, unported
options raise, and the package imports neither JAX nor the JAX package."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from spinnerf_tpu.config import Config as JConfig
from spinnerf_tpu.data import llff, synthetic
from spinnerf_tpu.train.loop import Trainer as JTrainer
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.models.fields import NeRFField
from spinnerf_tpu_torch.models.hashgrid import HashGridField
from spinnerf_tpu_torch.ops.fused_mlp import FusedMLPField
from spinnerf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene_pair(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"),
                             n_views=6, h=36, w=44, factor=1)
    sc = llff.load_scene(d, factor=1, prepare=True)
    tsc = tllff.Scene(**{f.name: getattr(sc, f.name)
                         for f in dataclasses.fields(llff.Scene)})
    return d, sc, tsc


def tiny(cls, tmp_path, datadir, **kw):
    base = dict(expname="t", basedir=str(tmp_path), datadir=str(datadir),
                factor=1, no_ndc=True, prepare=True, log2_hashmap_size=13,
                hash_region_calib=True, N_samples=12, N_importance=6,
                N_rand=64, lrate=1e-2, i_print=0, i_weights=0, i_video=0,
                i_testset=0, i_feat=0, compute_dtype="float32",
                llffhold=1000000)
    base.update(kw)
    return cls(**base)


def test_trainer_fits_and_psnr_rises(scene_pair, tmp_path):
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d), scene=tsc, device="cpu",
                 log=lambda *a: None)
    psnrs = []
    for i in range(1, 31):
        psnrs.append(float(tr.fit(i)["psnr"]))
    assert tr.step == 30 and tr.optimizer.count == 30
    assert np.isfinite(psnrs).all()
    # seeded, so deterministic; measured +0.6 dB over these 30 steps
    assert np.mean(psnrs[-5:]) > np.mean(psnrs[:5]) + 0.3, psnrs


def test_mlp_trainer_with_separate_fine_net(scene_pair, tmp_path):
    """--no_tcnn: the fused MLP field (its plain version on the CPU), a fine
    net sized by netdepth_fine/netwidth_fine, no hash sidecar."""
    d, _, tsc = scene_pair
    cfg = tiny(Config, tmp_path, d, no_tcnn=True, netdepth=3, netwidth=32,
               netdepth_fine=4, netwidth_fine=16, lrate=5e-3)
    tr = Trainer(cfg, scene=tsc, device="cpu", log=lambda *a: None)
    coarse, fine = tr.fields["coarse"], tr.fields["fine"]
    assert isinstance(coarse, FusedMLPField)
    assert isinstance(fine, FusedMLPField)
    assert (coarse.dims.depth, coarse.dims.width) == (3, 32)
    assert (fine.dims.depth, fine.dims.width) == (4, 16)
    assert not (tr.exp_dir / "page_bounds.json").exists()
    psnrs = [float(tr.fit(i)["psnr"]) for i in range(1, 21)]
    assert np.isfinite(psnrs).all()
    # seeded, so deterministic; measured +0.61 dB over these 20 steps
    assert np.mean(psnrs[-5:]) > np.mean(psnrs[:5]) + 0.2, psnrs
    # without view directions the trainer takes the plain NeRFField
    cfg2 = tiny(Config, tmp_path / "nv", d, no_tcnn=True, netdepth=2,
                netwidth=16, use_viewdirs=False, N_importance=0)
    tr2 = Trainer(cfg2, scene=tsc, device="cpu", log=lambda *a: None)
    assert isinstance(tr2.fields["coarse"], NeRFField)
    assert np.isfinite(float(tr2.fit(2)["loss"]))


def test_sidecar_matches_jax_trainer(scene_pair, tmp_path):
    d, sc, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path / "t", d), scene=tsc, device="cpu",
                 log=lambda *a: None)
    jt = JTrainer(tiny(JConfig, tmp_path / "j", d, hash_impl="win_xla"),
                  scene=sc, log=lambda *a: None)
    side_t = json.loads((tr.exp_dir / "page_bounds.json").read_text())
    side_j = json.loads((jt.exp_dir / "page_bounds.json").read_text())
    assert side_t == side_j
    assert side_t["page_bounds"] is not None
    assert tr.model.page_bounds == jt.model.page_bounds
    assert tr.model.dense_box == jt.model.dense_box


def test_checkpoint_round_trip_and_pinned_sidecar(scene_pair, tmp_path):
    d, _, tsc = scene_pair
    cfg = tiny(Config, tmp_path, d, i_weights=2)
    tr = Trainer(cfg, scene=tsc, device="cpu", log=lambda *a: None)
    tr.fit(4)
    assert tr.ckpt.steps() == [4, 2]
    # resume with calibration off: the pinned sidecar still applies
    cfg2 = tiny(Config, tmp_path, d, i_weights=2, hash_region_calib=False)
    tr2 = Trainer(cfg2, scene=tsc, device="cpu", log=lambda *a: None)
    assert tr2.step == 4 and tr2.optimizer.count == 4
    assert tr2.model.page_bounds == tr.model.page_bounds
    for (n, p), (_, q) in zip(tr.fields.named_parameters(),
                              tr2.fields.named_parameters()):
        assert torch.equal(p, q), n
    a = tr.optimizer.adam.state_dict()["state"]
    b = tr2.optimizer.adam.state_dict()["state"]
    assert all(torch.equal(a[k]["exp_avg_sq"], b[k]["exp_avg_sq"]) for k in a)


@pytest.mark.parametrize("flag", [
    dict(ft_path="x"), dict(colmap_depth=True), dict(lpips=True),
    dict(alpha_model_path="x"), dict(mesh_shape=2), dict(hash_impl="mxu")])
def test_unported_options_raise(scene_pair, tmp_path, flag):
    d, _, tsc = scene_pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(tiny(Config, tmp_path, d, **flag), scene=tsc, device="cpu",
                log=lambda *a: None)


def test_unported_hooks_raise_before_training(scene_pair, tmp_path):
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d, i_feat=10), scene=tsc,
                 device="cpu", log=lambda *a: None)
    with pytest.raises(NotImplementedError, match="prepare disparity dump"):
        tr.fit(2)
    assert tr.step == 0
    tr.fit(2, hooks=False)
    assert tr.step == 2


def test_no_device_raises_without_explicit_cpu(scene_pair, tmp_path,
                                               monkeypatch):
    d, _, tsc = scene_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tiny(Config, tmp_path, d), scene=tsc, log=lambda *a: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HashGridField(log2_table_size=13)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spinnerf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'spinnerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'spinnerf_tpu' or k.startswith('spinnerf_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('spinnerf_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20
