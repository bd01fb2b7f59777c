"""The port's Trainer on the CPU at a small size: it trains, pins the same
hash-index sidecar as the JAX Trainer, loads a scene directory with COLMAP
sparse depth and takes the JAX Trainer's first step there, samples the
--no_batching batches, checkpoints and --ft_path round-trip, the live control
file applies, --lpips refuses patches under 16 pixels, --alpha_model_path
freezes another experiment's density, the fit-mode sanity panel and the
MVSeg panel are written, unported options raise, and the package imports neither JAX nor the JAX
package."""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spinnerf_tpu.config import Config as JConfig
from spinnerf_tpu.data import llff, synthetic
from spinnerf_tpu.data import raybank as jraybank
from spinnerf_tpu.train.loop import Trainer as JTrainer
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.convert import fields_state_dicts
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import raybank as traybank
from spinnerf_tpu_torch.eval import render as eval_render
from spinnerf_tpu_torch.eval.metrics import to8b
from spinnerf_tpu_torch.eval.render import read_png
from spinnerf_tpu_torch.models.fields import NeRFField
from spinnerf_tpu_torch.models.hashgrid import HashGridField
from spinnerf_tpu_torch.ops.fused_mlp import FusedMLPField
from spinnerf_tpu_torch.train.loop import Trainer, render_config
from spinnerf_tpu_torch.utils.live_control import LiveControl

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
    dict(dataset_type="blender", mesh_shape=2),
    dict(dataset_type="dtu", mesh_shape=4), dict(mesh_shape=2)])
def test_unported_options_raise(scene_pair, tmp_path, flag):
    """Through the disk loader (no scene handed in), whatever the dataset
    type: --mesh_shape (ROADMAP A8). The Blender and DTU loaders are ported
    and trained in `tests/test_torch_loaders.py`."""
    d, _, _ = scene_pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(tiny(Config, tmp_path, d, **flag), device="cpu",
                log=lambda *a: None)


def test_mvseg_panel_hook_writes_its_png(scene_pair, tmp_path):
    """At i_img the MVSeg Trainer writes one training view's render beside
    its sigmoid(prob) map, the view `RandomState(step).choice(i_train)`, as
    the JAX Trainer does."""
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d, mvseg=True, i_img=3), scene=tsc,
                 device="cpu", log=lambda *a: None)
    tr.fit(3)
    out = tr.exp_dir / "test_renders"
    assert sorted(p.name for p in out.glob("*.png")) == ["t_seg_000003.png"]
    panel = read_png(out / "t_seg_000003.png")
    assert panel.shape == (36, 88, 3)
    idx = int(np.random.RandomState(3).choice(tr.i_train))
    maps = eval_render.make_param_frame_renderer(
        tsc.hwf, tr.fields, render_config(tr.cfg, train=False),
        near=tr.bank.near, far=tr.bank.far, ndc=tr.bank.ndc,
        maps=("rgb", "prob"), device="cpu")(tsc.poses[idx])
    prob = 1.0 / (1.0 + np.exp(-maps["prob"]))
    np.testing.assert_array_equal(panel[:, 44:],
                                  to8b(np.repeat(prob[..., None], 3, -1)))
    np.testing.assert_array_equal(panel[:, :44], to8b(maps["rgb"]))


def test_lpips_with_too_small_patches_raises(scene_pair, tmp_path):
    """36 x 44 views at the default factors (2, 8) give 4 x 4 patches: the
    Trainer refuses them (the JAX package's LPIPS is NaN there); without
    masks there is no patch term to refuse."""
    d, _, tsc = scene_pair
    for kw in (dict(scene=tsc), {}):
        with pytest.raises(ValueError, match="patch_len_factor 8"):
            Trainer(tiny(Config, tmp_path, d, prepare=False, lpips=True),
                    device="cpu", log=lambda *a: None, **kw)
    tr = Trainer(tiny(Config, tmp_path / "nm", d, prepare=False, lpips=True),
                 scene=dataclasses.replace(tsc, masks=None), device="cpu",
                 log=lambda *a: None)
    assert "lpips_loss" not in tr.fit(1)


def test_missing_alpha_checkpoint_raises(scene_pair, tmp_path):
    d, _, tsc = scene_pair
    for path in (tmp_path / "none", tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            Trainer(tiny(Config, tmp_path / "t", d,
                         alpha_model_path=str(path)),
                    scene=tsc, device="cpu", log=lambda *a: None)


def test_alpha_model_path_freezes_the_density(scene_pair, tmp_path):
    """The frozen field is the alpha experiment's fine field; after training
    the step's density is still the frozen field's, which neither the
    optimizer nor the checkpoint file saw change. The alpha experiment is a
    prepare run with every view in training and the fit holds two views
    out (N_gt=2), so the two experiments calibrate other page bounds: the
    frozen field reads its table under its own experiment's, bit for bit
    the alpha field's density. Without that sidecar the Trainer raises."""
    d, _, tsc = scene_pair
    src = Trainer(tiny(Config, tmp_path / "a", d, expname="alpha",
                       i_weights=2), scene=tsc, device="cpu",
                  log=lambda *a: None)
    src.fit(2)
    ckpt = src.ckpt.path(2).read_bytes()
    tr = Trainer(tiny(Config, tmp_path / "b", d, prepare=False, N_gt=2,
                      alpha_model_path=str(src.exp_dir)),
                 scene=tsc, device="cpu", log=lambda *a: None)
    assert len(tr.i_train) == len(src.i_train) - 2
    assert tr.frozen.page_bounds == src.model.page_bounds
    assert tr.model.page_bounds != src.model.page_bounds
    for (n, p), q in zip(src.fields["fine"].named_parameters(),
                         tr.frozen.parameters()):
        assert torch.equal(p, q) and not q.requires_grad, n
    frozen = {n: p.clone() for n, p in tr.frozen.named_parameters()}
    tr.fit(3)
    assert src.ckpt.path(2).read_bytes() == ckpt
    for n, p in tr.frozen.named_parameters():
        assert torch.equal(p, frozen[n]), n
    batch, _ = traybank.sample_group(tr.bank, "clf", 16, step=1)
    pts = batch["origins"][:, None] + batch["directions"][:, None] * \
        torch.linspace(2.0, 4.0, 5)[:, None]
    with torch.no_grad():
        want = tr.frozen(pts, batch["viewdirs"])[..., 3]
        assert torch.equal(src.fields["fine"](pts, batch["viewdirs"])[
            ..., 3], want)
        for fn in tr.step_fn.field_fns:
            assert torch.equal(fn(pts, batch["viewdirs"])[..., 3], want)
        assert not torch.equal(tr.fields["fine"](pts, batch["viewdirs"])[
            ..., 3], want)
    (src.exp_dir / "page_bounds.json").unlink()
    with pytest.raises(ValueError, match="page_bounds.json"):
        Trainer(tiny(Config, tmp_path / "c", d, prepare=False,
                     alpha_model_path=str(src.exp_dir)),
                scene=tsc, device="cpu", log=lambda *a: None)


def test_sanity_panel_hook_writes_its_png(scene_pair, tmp_path):
    """Outside prepare mode, i_feat > 10 writes the render / prior /
    disparity panel of one training view at each multiple, then training
    goes on; i_feat <= 10 writes none."""
    d, _, tsc = scene_pair
    tr = Trainer(tiny(Config, tmp_path, d, prepare=False, i_feat=11),
                 scene=tsc, device="cpu", log=lambda *a: None)
    tr.fit(12)
    out = tr.exp_dir / "test_renders"
    assert sorted(p.name for p in out.iterdir()) == ["t_000011.png"]
    panel = read_png(out / "t_000011.png")
    h, w = tsc.images.shape[1:3]
    assert panel.shape == (h, 3 * w, 3)
    idx = int(np.random.RandomState(11).choice(tr.i_train))
    tr2 = Trainer(tiny(Config, tmp_path / "r", d, prepare=False, i_feat=11),
                  scene=tsc, device="cpu", log=lambda *a: None)
    tr2.fit(11, hooks=False)
    rgbs, _ = tr2.render_poses_list(tsc.poses[idx:idx + 1])
    np.testing.assert_array_equal(panel[:, :w], to8b(rgbs[0]))
    # the prior and the disparity, each scaled to the full 8-bit range
    assert panel[:, w:].min() == 0 and panel[:, w:2 * w].max() == 255
    assert tr.step == 12
    tr3 = Trainer(tiny(Config, tmp_path / "s", d, prepare=False, i_feat=10),
                  scene=tsc, device="cpu", log=lambda *a: None)
    tr3.fit(10)
    assert not (tr3.exp_dir / "test_renders").exists()


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
        "importlib.import_module('spinnerf_tpu_torch.cli.__main__')\n"
        "for m in NEW:\n"
        "    assert 'spinnerf_tpu_torch.' + m in sys.modules, m\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'spinnerf_tpu' or k.startswith('spinnerf_tpu.')]\n"
        "assert not bad, bad\n"
        "lazy = [k for k in sys.modules\n"
        "        if k.split('.')[0] in ('cv2', 'matplotlib', 'PIL')]\n"
        "assert not lazy, lazy\n"
        "print(len([k for k in sys.modules if k.startswith('spinnerf_tpu_torch')]))\n")
    # the LaMa-training modules, none of which may import cv2, matplotlib
    # or PIL when imported
    new = ["data.lama_masks", "data.shards", "models.batchnorm",
           "models.discriminator", "models.segmentation", "models.inception",
           "models.generators", "train.lama_losses", "train.lama_trainer",
           "train.lama_loop", "eval.inpainting", "eval.masks",
           "utils.countless", "pipeline.lama_tools"]
    out = subprocess.run([sys.executable, "-c", f"NEW = {new!r}\n" + code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


@pytest.fixture(scope="module")
def disk_scene(tmp_path_factory):
    """A JAX-written scene directory at factor 2 (24 x 32 images) with its
    COLMAP model."""
    return synthetic.make_scene(tmp_path_factory.mktemp("disk"), n_views=5,
                                h=48, w=64, factor=2, n_points=400)


def _ds_nerf(cls, tmp_path, datadir, **kw):
    """The reference's DS-NeRF prepare configuration (`tools/full_run.py:
    128-147`) at a small MLP, with perturb and density noise off so that a
    step is deterministic. The MLP runs at 2 octaves: at 10 the top octave
    scales the f32 differences of the two pipelines' sample points by 512
    (`tests/test_torch_train_step.py`)."""
    return tiny(cls, tmp_path, datadir, factor=2, colmap_depth=True,
                depth_loss=True, depth_lambda=0.1, lindisp=True,
                white_bkgd=True, perturb=0.0, raw_noise_std=0.0,
                no_tcnn=True, fused_mlp=False, netdepth=4, netwidth=32,
                netdepth_fine=4, netwidth_fine=32, multires=2,
                multires_views=2, N_samples=16, N_importance=8, **kw)


def test_disk_trainer_with_colmap_depth_matches_jax(disk_scene, tmp_path):
    """No scene handed in: both Trainers load the directory and its sparse
    depth; from the same weights the first step's loss terms, the depth
    term included, agree within 1e-5 relative (the bound of
    `tests/test_torch_train_step.py`; measured <= 7.3e-7, the depth
    term)."""
    tr = Trainer(_ds_nerf(Config, tmp_path / "t", disk_scene), device="cpu",
                 log=lambda *a: None)
    jt = JTrainer(_ds_nerf(JConfig, tmp_path / "j", disk_scene),
                  log=lambda *a: None)
    assert set(tr.load_s) == {"scene", "sparse_depth"}
    assert tr.scene.images.shape == (5, 24, 32, 3)
    assert tr.bank.depth_group.count == jt.bank.depth_group.count > 100
    np.testing.assert_array_equal(tr.bank.depth_group.depth.numpy(),
                                  np.asarray(jt.bank.depth_group.depth))
    assert tr._batches_per_step() == jt._batches_per_step() == 3
    with torch.no_grad():
        for k, sd in fields_state_dicts(
                jax.tree.map(np.asarray, jt.state.params)).items():
            tr.fields[k].load_state_dict(sd)
    _, _, jm = jt.step_fn(jt.state.params, jt.state.opt_state,
                          jax.random.PRNGKey(0), 1)
    _, tm = tr.step_fn.loss_fn(1, tr.generator)
    assert set(tm) == set(jm) and "depth_loss" in tm
    for name in jm:
        want = float(jm[name])
        assert abs(float(tm[name].detach()) - want) <= 1e-5 * abs(want), \
            name


def test_no_batching_batches_match_jax(disk_scene, tmp_path):
    """--no_batching: the port's batch for the view, rows and columns that
    JAX `sample_single_image` draws from its key equals JAX's batch; the
    crop bounds hold while step < precrop_iters; the trainer steps."""
    tr = Trainer(_ds_nerf(Config, tmp_path, disk_scene, no_batching=True,
                          precrop_iters=3, precrop_frac=0.5), device="cpu",
                 log=lambda *a: None)
    jsc = llff.load_scene(disk_scene, factor=2, prepare=True)
    jbank = jraybank.build_raybank(jsc, np.arange(5), prepare=True)
    h, w = tr.bank.hwf[:2]
    for step, key in ((1, 3), (7, 4)):
        k = jax.random.PRNGKey(key)
        jb, jtg = jraybank.sample_single_image(k, jbank, 64, step,
                                               precrop_iters=3)
        # the draws inside the JAX sampler, replayed from its key
        k_view, k_row, k_col = jax.random.split(k, 3)
        r0, r1, c0, c1 = traybank.single_image_bounds(tr.bank.hwf, step, 3)
        view = int(jax.random.randint(k_view, (), 0, 5))
        row = np.array(jax.random.randint(k_row, (64,), r0, r1))
        col = np.array(jax.random.randint(k_col, (64,), c0, c1))
        assert (r0, r1, c0, c1) == ((6, 18, 8, 24) if step < 3
                                    else (0, h, 0, w))
        tb, ttg = traybank.pixel_batch(
            tr.bank, torch.full((64,), view), torch.from_numpy(row).long(),
            torch.from_numpy(col).long(), inp_depth=False)
        assert set(tb) == set(jb) and set(ttg) == set(jtg)
        for name in jb:
            np.testing.assert_allclose(tb[name].numpy(), np.asarray(jb[name]),
                                       rtol=0, atol=1e-6, err_msg=name)
        for name in jtg:
            np.testing.assert_array_equal(ttg[name].numpy(),
                                          np.asarray(jtg[name]))
    gen = torch.Generator().manual_seed(0)
    batch, tg = traybank.sample_single_image(tr.bank, 256, 1,
                                             precrop_iters=3, generator=gen)
    assert tg["rgb"].shape == (256, 3)
    m = float(tr.fit(2)["loss"])
    assert np.isfinite(m)


def test_ft_path_round_trip(scene_pair, tmp_path):
    """--ft_path takes an experiment directory, its checkpoints/ directory
    or one file (a parameters-only file keeps the fresh optimizer); it wins
    over the experiment's own checkpoints."""
    d, _, tsc = scene_pair
    src = Trainer(tiny(Config, tmp_path / "src", d, i_weights=3), scene=tsc,
                  device="cpu", log=lambda *a: None)
    src.fit(3)
    ckpt = src.ckpt.path(3)
    params_only = tmp_path / "params_3.pt"
    torch.save({"params": src.fields.state_dict()}, params_only)
    for path, count in ((src.exp_dir, 3), (src.exp_dir / "checkpoints", 3),
                        (ckpt, 3), (params_only, 0)):
        tr = Trainer(tiny(Config, tmp_path / "dst", d, ft_path=str(path),
                          no_reload=False), scene=tsc, device="cpu",
                     log=lambda *a: None)
        assert tr.step == 3 and tr.optimizer.count == count, path
        for (n, p), (_, q) in zip(src.fields.named_parameters(),
                                  tr.fields.named_parameters()):
            assert torch.equal(p, q), n
    with pytest.raises(FileNotFoundError):
        Trainer(tiny(Config, tmp_path / "x", d, ft_path=str(tmp_path / "no")),
                scene=tsc, device="cpu", log=lambda *a: None)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Trainer(tiny(Config, tmp_path / "y", d, ft_path=str(tmp_path / "y")),
                scene=tsc, device="cpu", log=lambda *a: None)


def test_live_control_applies_control_file(scene_pair, tmp_path):
    """fit polls <exp_dir>/control.json at i_print: mutable keys apply
    (converted to the option's type), others are logged and skipped."""
    d, _, tsc = scene_pair
    logs = []
    tr = Trainer(tiny(Config, tmp_path, d, i_print=2), scene=tsc,
                 device="cpu", log=logs.append)
    (tr.exp_dir / "control.json").write_text(json.dumps(
        {"render_factor": 4, "i_print": "3", "N_rand": 8, "i_video": "x"}))
    tr.fit(2)
    assert tr.cfg.render_factor == 4 and tr.cfg.i_print == 3
    assert tr.cfg.N_rand == 64 and tr.cfg.i_video == 0
    assert any("key not mutable: N_rand" in m for m in logs)
    assert any("bad value for i_video" in m for m in logs)
    # a poller reads the file again only when it changes
    ctl = LiveControl(tr.cfg, log=logs.append)
    assert ctl.poll() == {"render_factor": 4, "i_print": 3}
    assert ctl.poll() == {}
