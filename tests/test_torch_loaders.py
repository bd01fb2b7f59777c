"""The port's Blender, DTU and NeRD loaders and their dispatch branches
(`spinnerf_tpu_torch/data/{blender,dtu,dispatch}.py`) against the JAX
package's on cv2-written scenes: poses within 1e-6 (pose_spherical) and
1e-10 (decompose_projection); images equal at full resolution and within
2.4e-7 at half resolution (cv2's float INTER_AREA sums in another order);
masks, object images, splits and near/far equal. Then a toy Blender and a
toy DTU Trainer on the CPU: bank near/far and the first batch's rays equal
to the JAX bank's, two steps with a finite, falling loss."""
import json
import shutil
import types

import cv2
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import blender as jblender
from spinnerf_tpu.data import dispatch as jdispatch
from spinnerf_tpu.data import dtu as jdtu
from spinnerf_tpu.data import raybank as jraybank
from spinnerf_tpu.data import synthetic as jsynthetic
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import blender as tblender
from spinnerf_tpu_torch.data import dispatch as tdispatch
from spinnerf_tpu_torch.data import dtu as tdtu
from spinnerf_tpu_torch.data import raybank as traybank
from spinnerf_tpu_torch.data import synthetic as tsynthetic
from spinnerf_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)

HALF_RES_TOL = 2.4e-7     # cv2 sums a 2 x 2 float block in its own order
H, W = 40, 48


def _world_rgba(c2w, h, w, focal):
    """The plane-and-ball world as an RGBA frame: alpha 1 on the ball and on
    the table (the plane within radius 1.5), 0 elsewhere."""
    rgb, z, hit = tsynthetic.render_view(c2w, h, w, focal)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    d = np.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal,
                  -np.ones_like(i)], -1) @ c2w[:3, :3].T
    p = c2w[:3, 3] + np.where(np.isfinite(z), z, 0.0)[..., None] * d
    table = np.isfinite(z) & (np.linalg.norm(p[..., :2], axis=-1) < 1.5)
    alpha = (hit | table).astype(np.float32)
    return np.concatenate([rgb, alpha[..., None]], -1)


def write_blender_scene(d, n=(4, 2, 2), h=H, w=W, masks=True):
    """transforms_{train,val,test}.json and cv2-written RGBA frames of the
    world from pose_spherical(theta, -30, 4); masks (the ball) and object
    images on the train views but the last."""
    angle_x = 0.6911
    focal = 0.5 * w / np.tan(0.5 * angle_x)
    k = 0
    for split, count in zip(("train", "val", "test"), n):
        (d / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(count):
            c2w = tblender.pose_spherical(-180 + 360 * k / sum(n), -30.0,
                                          4.0)[:3]
            k += 1
            rgba = _world_rgba(c2w, h, w, focal)
            cv2.imwrite(str(d / split / f"r_{i}.png"), cv2.cvtColor(
                (rgba * 255).astype(np.uint8), cv2.COLOR_RGBA2BGRA))
            if masks and split == "train" and i < count - 1:
                _, _, hit = tsynthetic.render_view(c2w, h, w, focal)
                (d / split / "mask").mkdir(exist_ok=True)
                (d / split / "object").mkdir(exist_ok=True)
                cv2.imwrite(str(d / split / "mask" / f"m_r_{i}.png"),
                            hit.astype(np.uint8) * 255)
                cv2.imwrite(str(d / split / "object" / f"o_r_{i}.png"),
                            (rgba[..., 2::-1] * hit[..., None] * 255)
                            .astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.concatenate(
                               [c2w, [[0, 0, 0, 1]]]).tolist()})
        (d / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": angle_x, "frames": frames}))
    return d


def write_dtu_scene(d, n=5, h=30, w=40):
    """image/*.png (cv2-written) of the world from a ring of cameras and
    cameras.npz with world_mat_<i> = K [R | t] in OpenCV's frame (4 x 4)."""
    (d / "image").mkdir(parents=True)
    focal = 1.2 * w
    k = np.array([[focal, 0, w / 2], [0, focal * 1.01, h / 2], [0, 0, 1.0]])
    mats = {}
    for v in range(n):
        th = 2 * np.pi * v / n
        c2w = tsynthetic.look_at_pose(
            [3.0 * np.cos(th), 3.0 * np.sin(th), 1.8], target=(0, 0, 0.3))
        rgb, _, _ = tsynthetic.render_view(c2w, h, w, focal)
        cv2.imwrite(str(d / "image" / f"{v:06d}.png"),
                    cv2.cvtColor((rgb * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        r_cv = np.stack([c2w[:, 0], -c2w[:, 1], -c2w[:, 2]], 1).T
        p = np.eye(4)
        p[:3] = k @ np.concatenate([r_cv, (-r_cv @ c2w[:, 3])[:, None]], 1)
        mats[f"world_mat_{v}"] = p
    np.savez(d / "cameras.npz", **mats)
    return d


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    return write_blender_scene(tmp_path_factory.mktemp("blender"))


@pytest.fixture(scope="module")
def dtu_dir(tmp_path_factory):
    return write_dtu_scene(tmp_path_factory.mktemp("dtu") / "scan")


def test_pose_spherical_matches_jax():
    for th, phi, r in ((0.0, -30.0, 4.0), (123.0, -30.0, 4.0),
                       (-170.0, 15.0, 2.5), (90.0, -89.0, 6.0)):
        np.testing.assert_allclose(tblender.pose_spherical(th, phi, r),
                                   jblender.pose_spherical(th, phi, r),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("half_res", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("testskip", [1, 2])
def test_load_blender_matches_jax(blender_dir, half_res, testskip):
    got = tblender.load_blender_data(blender_dir, half_res=half_res,
                                     testskip=testskip)
    want = jblender.load_blender_data(blender_dir, half_res=half_res,
                                      testskip=testskip)
    (gi, gp, grp, ghwf, gs, gm, go), (wi, wp, wrp, whwf, ws, wm, wo) = \
        got, want
    assert gi.dtype == wi.dtype == np.float32 and gi.shape == wi.shape
    assert gi.shape[1:] == ((H // 2, W // 2, 4) if half_res else (H, W, 4))
    if half_res:
        np.testing.assert_allclose(gi, wi, rtol=0, atol=HALF_RES_TOL)
        np.testing.assert_allclose(go, wo, rtol=0, atol=HALF_RES_TOL)
    else:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(go, wo)
    assert (gi[..., 3] == 0).any() and (gi[..., 3] == 1).any()
    np.testing.assert_array_equal(gm, wm)
    assert (gm == -1).any() and (gm == 1).any()
    assert go.dtype == wo.dtype and (go > 0).any()
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(grp, wrp, rtol=0, atol=1e-6)
    assert ghwf == whwf
    for a, b in zip(gs, ws):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tblender.composite_white(gi),
                                  jblender.composite_white(gi))


def test_decompose_projection_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(8):
        k = np.array([[rng.uniform(300, 900), rng.uniform(-2, 2), 64.0],
                      [0, rng.uniform(300, 900), 48.0], [0, 0, 1.0]])
        q, _ = np.linalg.qr(rng.randn(3, 3))
        q *= np.sign(np.linalg.det(q))
        p = rng.uniform(0.5, 3.0) * k @ np.concatenate(
            [q, (-q @ rng.randn(3))[:, None]], 1)
        gk, gc = tdtu.decompose_projection(p)
        wk, wc = jdtu.decompose_projection(p)
        np.testing.assert_allclose(gk, wk, rtol=0, atol=1e-10)
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-10)
        assert gc.dtype == wc.dtype == np.float32


def test_load_dtu_matches_jax(dtu_dir):
    gi, gp, ghwf = tdtu.load_dtu_data(dtu_dir)
    wi, wp, whwf = jdtu.load_dtu_data(dtu_dir)
    assert gi.shape == (5, 30, 40, 3)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gp, wp)
    assert ghwf == whwf


def test_load_nerd_matches_jax(tmp_path):
    d = jsynthetic.make_scene(tmp_path / "nerd", n_views=4, h=36, w=48,
                              factor=2, n_points=200)
    shutil.copytree(d / "images_2" / "label", d / "images_2" / "masks")
    (d / "images_2" / "objects").mkdir()
    rng = np.random.RandomState(1)
    for v in range(4):
        cv2.imwrite(str(d / "images_2" / "objects" / f"o{v}.png"),
                    rng.randint(0, 256, (18, 24, 3)).astype(np.uint8))
    got = tdtu.load_nerd_data(d, factor=2)
    want = jdtu.load_nerd_data(d, factor=2)
    for name, a, b in zip(("images", "poses", "bounds", "render_poses",
                           "i_holdout", "masks", "objects"), got, want):
        if name in ("poses", "bounds", "render_poses"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[6].shape == (4, 18, 24, 3)


def _cfg(dataset_type, datadir, **kw):
    base = dict(dataset_type=dataset_type, datadir=str(datadir),
                half_res=False, testskip=8, white_bkgd=False,
                train_scene=[], test_scene=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("case", [
    dict(dataset_type="blender"),
    dict(dataset_type="blender", half_res=True, white_bkgd=True, testskip=1),
    dict(dataset_type="dtu"),
    dict(dataset_type="dtu", test_scene=[1, 3]),
    dict(dataset_type="dtu", test_scene=[1], train_scene=[0, 1, 2])],
    ids=["blender", "blender_half_white", "dtu", "dtu_test",
         "dtu_train_scene"])
def test_dispatch_branches_match_jax(blender_dir, dtu_dir, tmp_path, case):
    case = dict(case)
    dt = case.pop("dataset_type")
    d = blender_dir if dt == "blender" else dtu_dir
    got_scene, *got = tdispatch.load_scene_for_config(_cfg(dt, d, **case))
    want_scene, *want = jdispatch.load_scene_for_config(_cfg(dt, d, **case))
    for name in ("images", "poses", "bounds", "render_poses", "masks"):
        a, b = getattr(got_scene, name), getattr(want_scene, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            if name == "images" and case.get("half_res"):
                np.testing.assert_allclose(a, b, rtol=0, atol=HALF_RES_TOL)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert got_scene.hwf == want_scene.hwf
    assert got_scene.i_holdout == want_scene.i_holdout
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:] == ([2.0, 6.0] if dt == "blender"
                                   else [0.1, 5.0])
    if dt == "blender":
        assert got_scene.masks is not None and got_scene.images.shape[-1] == 3
    if dt == "dtu" and not case.get("train_scene"):
        assert not set(got[0]) & set(got[1])


def test_blender_without_masks_trains_plainly(tmp_path):
    d = write_blender_scene(tmp_path / "plain", n=(2, 1, 1), masks=False)
    scene, i_train, i_test, near, far = tdispatch.load_scene_for_config(
        _cfg("blender", d, testskip=1))
    assert scene.masks is None and (near, far) == (2.0, 6.0)
    assert list(i_train) == [0, 1] and list(i_test) == [3]


def _toy(dataset_type, tmp_path, datadir, **kw):
    return Config(expname=dataset_type, basedir=str(tmp_path),
                  datadir=str(datadir), dataset_type=dataset_type,
                  prepare=True, log2_hashmap_size=13, N_samples=12,
                  N_importance=6, N_rand=64, lrate=1e-2, i_print=0,
                  i_weights=0, i_video=0, i_testset=0, i_feat=0,
                  compute_dtype="float32", **kw)


@pytest.mark.parametrize("dataset_type", ["blender", "dtu"])
def test_toy_trainer_matches_jax_bank(blender_dir, dtu_dir, tmp_path,
                                      dataset_type):
    kw = (dict(half_res=True, white_bkgd=True, testskip=1)
          if dataset_type == "blender" else {})
    d = blender_dir if dataset_type == "blender" else dtu_dir
    tr = Trainer(_toy(dataset_type, tmp_path, d, **kw), device="cpu",
                 log=lambda *a: None)
    assert not tr.bank.ndc
    scene, i_train, _, near, far = jdispatch.load_scene_for_config(
        _cfg(dataset_type, d, **kw))
    jbank = jraybank.build_raybank(scene, i_train, prepare=True, near=near,
                                   far=far)
    assert (tr.bank.near, tr.bank.far) == (jbank.near, jbank.far) == (
        (2.0, 6.0) if dataset_type == "blender" else (0.1, 5.0))
    np.testing.assert_array_equal(tr.i_train, i_train)
    jb, jtg = jraybank.sample_group(None, jbank, "rgb", 64, step=0)
    tb, ttg = traybank.sample_group(tr.bank, "rgb", 64, step=0)
    for name in jb:
        np.testing.assert_allclose(tb[name].numpy(), np.asarray(jb[name]),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ttg["rgb"].numpy(), np.asarray(jtg["rgb"]))
    losses = [float(tr.fit(i)["loss"]) for i in (1, 2)]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
