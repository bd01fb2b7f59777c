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


@pytest.mark.parametrize("impl", ["mxu", "xla"])
def test_idx_trainer_fits_and_psnr_rises(scene_pair, tmp_path, impl):
    """The instant-NGP index (dense / XOR-prime) at a 2^12 table, through
    `hash_encode_mxu` (its plain version on the CPU); it pins the same
    page_bounds.json sidecar as the JAX Trainer with --hash_impl xla."""
    d, sc, tsc = scene_pair
    cfg = tiny(Config, tmp_path / "t", d, log2_hashmap_size=12,
               hash_impl=impl)
    tr = Trainer(cfg, scene=tsc, device="cpu", log=lambda *a: None)
    assert tr.model.encoder.impl == impl
    psnrs = [float(tr.fit(i)["psnr"]) for i in range(1, 31)]
    assert np.isfinite(psnrs).all()
    # seeded, so deterministic; measured +0.92 dB over these 30 steps
    assert np.mean(psnrs[-5:]) > np.mean(psnrs[:5]) + 0.4, psnrs
    jt = JTrainer(tiny(JConfig, tmp_path / "j", d, log2_hashmap_size=12,
                       hash_impl="xla"), scene=sc, log=lambda *a: None)
    side_t = json.loads((tr.exp_dir / "page_bounds.json").read_text())
    assert side_t == json.loads(
        (jt.exp_dir / "page_bounds.json").read_text())
    assert side_t["dense_box"] is not None


@pytest.mark.parametrize("flag", [
    dict(ft_path="x"), dict(colmap_depth=True), dict(lpips=True),
    dict(alpha_model_path="x"), dict(mesh_shape=2)])
def test_unported_options_raise(scene_pair, tmp_path, flag):
    d, _, tsc = scene_pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(tiny(Config, tmp_path, d, **flag), scene=tsc, device="cpu",
                log=lambda *a: None)


def test_unported_hooks_raise_before_training(scene_pair, tmp_path):
    """The sanity panel (i_feat > 10 outside prepare mode) is not ported:
    fit raises before its first step when the hook would fire."""
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d, prepare=False, i_feat=20),
                 scene=tsc, device="cpu", log=lambda *a: None)
    tr.fit(2)
    assert tr.step == 2
    with pytest.raises(NotImplementedError, match="sanity-panel"):
        tr.fit(20)
    assert tr.step == 2
    tr.fit(20, hooks=False)
    assert tr.step == 20


def _png_gray(path):
    import cv2
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None and img.dtype == np.uint8 and img.ndim == 2, path
    return img


def test_prepare_dump_at_the_final_step(scene_pair, tmp_path):
    """A prepare run with the default i_feat (10) stages the LaMa inputs at
    the last step of fit: one disparity PNG per view, equal to the port's
    own render as clip(nan_to_num(disp) * 255) in uint8, and the masks in
    label/."""
    d, _, tsc = scene_pair
    cfg = tiny(Config, tmp_path, d, i_feat=Config().i_feat)
    assert cfg.i_feat == 10
    tr = Trainer(cfg, scene=tsc, device="cpu", log=lambda *a: None)
    out = tr.exp_dir / "lama_input"
    tr.fit(2, hooks=False)
    assert not out.exists()
    tr.fit(3)
    n = len(tsc.images)
    assert sorted(p.name for p in out.glob("*.png")) == [
        f"img{i:03}.png" for i in range(n)]
    _, disps = tr.render_poses_list(tsc.poses)
    for i in range(n):
        want = np.clip(np.nan_to_num(disps[i]) * 255, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(_png_gray(out / f"img{i:03}.png"), want)
        np.testing.assert_array_equal(
            _png_gray(out / "label" / f"img{i:03}.png"),
            (np.clip(np.abs(tsc.masks[i]), 0, 1) * 255).astype(np.uint8))
    assert len(np.unique(_png_gray(out / "img000.png"))) > 1


def test_prepare_dump_without_masks_writes_no_labels(scene_pair, tmp_path):
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d, i_feat=10), device="cpu",
                 scene=dataclasses.replace(tsc, masks=None),
                 log=lambda *a: None)
    tr.fit(1)
    out = tr.exp_dir / "lama_input"
    assert len(list(out.glob("img*.png"))) == len(tsc.images)
    assert list((out / "label").iterdir()) == []


def test_testset_and_video_hooks(scene_pair, tmp_path):
    """i_testset dumps the held-out views' artifact tree with psnr.json
    (only at render_factor 0); i_video writes the spiral's rgb and disp
    videos (mp4 through imageio or cv2, else per-frame PNGs)."""
    d, _, tsc = scene_pair
    scene = dataclasses.replace(tsc, render_poses=tsc.render_poses[:2])
    cfg = tiny(Config, tmp_path, d, llffhold=3, i_testset=2, i_video=2)
    tr = Trainer(cfg, scene=scene, device="cpu", log=lambda *a: None)
    assert list(tr.i_test) == [0, 3]
    tr.fit(2)
    tdir = tr.exp_dir / "testset_000002"
    ps = json.loads((tdir / "psnr.json").read_text())
    assert len(ps["per_view"]) == 2 and np.isfinite(ps["mean"])
    for sub in ("rgb", "images"):
        assert sorted(p.name for p in (tdir / sub).iterdir()) == [
            "000000.png", "000001.png"]
    assert (tdir / "weight" / "000001.npy").exists()
    vdir = tr.exp_dir / "video_000002"
    for name in ("rgb.mp4", "disp.mp4"):
        assert (vdir / name).exists() or (vdir / f"{name}.frames").is_dir()
    cfg2 = tiny(Config, tmp_path / "rf", d, llffhold=3, i_testset=1,
                render_factor=2)
    tr2 = Trainer(cfg2, scene=tsc, device="cpu", log=lambda *a: None)
    tr2.fit(1)
    tdir2 = tr2.exp_dir / "testset_000001"
    assert (tdir2 / "rgb" / "000000.png").exists()
    assert not (tdir2 / "psnr.json").exists()


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
