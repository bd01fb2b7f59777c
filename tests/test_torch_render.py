"""The port's frame/path rendering and image metrics
(`spinnerf_tpu_torch/eval/`) against the JAX package's (`spinnerf_tpu/eval/`)
on the same converted NeRFField, plus the PNG writer and the video
fallback that the card's machine (no cv2, no imageio) relies on."""
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.core.rendering import RenderConfig as JRenderConfig
from spinnerf_tpu.data import synthetic
from spinnerf_tpu.eval import metrics as jmetrics
from spinnerf_tpu.eval import render as jrender
from spinnerf_tpu.models.fields import NeRFField as JField
from spinnerf_tpu_torch.convert import field_state_dict
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.eval import metrics as tmetrics
from spinnerf_tpu_torch.eval import render as trender
from spinnerf_tpu_torch.models.fields import NeRFField as TField

torch.set_num_threads(1)

H, W, FOCAL, S = 12, 16, 20.0, 16     # fine pass sees n_samples + n_importance
KW = dict(near=1.0, far=7.0, chunk=512)
CFG = dict(n_samples=8, n_importance=8, perturb=False, raw_noise_std=0.0)


@pytest.fixture(scope="module")
def fields():
    """The `tests/test_eval.py` set-up: a small f32 NeRFField, its JAX
    parameters carried to the port."""
    jf = JField(depth=2, width=32, multires=4, multires_views=2,
                compute_dtype=jnp.float32)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 3)),
                     jnp.zeros((1, 3)))
    tf = TField(depth=2, width=32, multires=4, multires_views=2,
                compute_dtype=torch.float32, device="cpu")
    tf.load_state_dict(field_state_dict(jax.tree.map(np.asarray, params)))

    def jfield(pts, vd):
        return jf.apply(params, pts, vd)

    return jfield, tf


def _poses():
    return np.stack([synthetic.look_at_pose(np.array(p))[:3, :4]
                     for p in ([3.0, 1.0, 1.5], [1.0, -3.0, 2.0])]
                    ).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# Coarse pass only: the two pipelines compute rays, depths and the MLP in f32
# in other orders, so the composited maps differ by a few ulps (measured
# <= 1.1e-6 of max |value| for rgb, acc and depth); disp = acc / depth
# divides two such sums, and at acc ~0.3 its error is a few times theirs
# (measured 8.9e-6). With importance sampling the reference's sampler is
# discontinuous: a bin's pdf is set to 1 where it falls below 1e-5
# (`sample_pdf`), and the pdf of an empty bin behind an opaque ray is
# 1e-5 / (1 + ...), within cumsum rounding of that guard, so an ulp in the
# coarse weights moves some fine samples by up to 5e-3 in depth; measured
# 1.4e-3 of max |value| on the maps.
MAP_TOL = {0: {"rgb": 1e-5, "acc": 1e-5, "depth": 1e-5, "disp": 3e-5},
           8: dict.fromkeys(("rgb", "acc", "depth", "disp"), 5e-3)}


@pytest.mark.parametrize("n_importance", [0, 8])
def test_frame_renderer_matches_jax(fields, n_importance):
    jfield, tf = fields
    cfg = dict(CFG, n_importance=n_importance)
    for c2w in _poses():
        want = jrender.make_frame_renderer((H, W, FOCAL), jfield,
                                           JRenderConfig(**cfg), **KW)(
            jax.random.PRNGKey(1), jnp.asarray(c2w))
        got = trender.make_frame_renderer((H, W, FOCAL), tf,
                                          RenderConfig(**cfg), device="cpu",
                                          **KW)(c2w)
        assert set(got) == set(want) == set(trender.LIGHT_MAPS)
        for m in trender.LIGHT_MAPS:
            assert got[m].shape == want[m].shape, m
            assert _rel(got[m], np.asarray(want[m])) <= \
                MAP_TOL[n_importance][m], m


def test_render_path_matches_jax_and_writes_the_same_tree(fields, tmp_path):
    jfield, tf = fields
    poses, gt = _poses(), np.random.RandomState(0).rand(2, H, W, 3)
    rgbs_j, disps_j = jrender.render_path(
        jax.random.PRNGKey(2), poses, (H, W, FOCAL), jfield,
        JRenderConfig(**CFG), save_dir=tmp_path / "j", gt_images=gt,
        save_alpha=True, **KW)
    rgbs_t, disps_t = trender.render_path(
        poses, (H, W, FOCAL), tf, RenderConfig(**CFG), save_dir=tmp_path / "t",
        gt_images=gt, save_alpha=True, device="cpu", **KW)
    assert rgbs_t.shape == rgbs_j.shape == (2, H, W, 3)
    assert _rel(rgbs_t, rgbs_j) <= MAP_TOL[8]["rgb"]
    assert _rel(disps_t, disps_j) <= MAP_TOL[8]["disp"]

    def tree(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*"))

    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    for name in ("intrinsics.txt", "pose/000001.txt"):
        np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / name),
                                   np.loadtxt(tmp_path / "j" / name),
                                   rtol=1e-6)
    for sub in ("depth", "weight", "z", "alpha"):
        a = np.load(tmp_path / "t" / sub / "000000.npy")
        b = np.load(tmp_path / "j" / sub / "000000.npy")
        assert a.shape == b.shape and _rel(a, b) <= 5e-3, sub
    # the PNGs decode to the same 8-bit images (an ulp may cross a level)
    for name in ("rgb/000000.png", "images/000001.png"):
        a = cv2.imread(str(tmp_path / "t" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_UNCHANGED)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


def test_frame_renderer_maps_contract(fields):
    """Default renderers return the light maps only; heavy maps come back
    per sample [H, W, S]; a map the field does not produce is refused before
    any rendering (as `tests/test_eval.py::test_frame_renderer_maps_contract`
    holds the JAX renderer)."""
    _, tf = fields
    cfg = RenderConfig(**CFG)
    c2w = _poses()[0]
    default = trender.make_frame_renderer((H, W, FOCAL), tf, cfg,
                                          device="cpu", **KW)(c2w)
    assert set(default) == set(trender.LIGHT_MAPS)
    assert default["rgb"].shape == (H, W, 3)
    assert default["disp"].shape == (H, W)
    heavy = trender.make_frame_renderer(
        (H, W, FOCAL), tf, cfg, maps=("rgb",) + trender.HEAVY_MAPS,
        device="cpu", **KW)(c2w)
    for m in trender.HEAVY_MAPS:
        assert heavy[m].shape == (H, W, S), m
    assert float(heavy["weights"].min()) >= 0.0
    assert float(heavy["weights"].sum(-1).max()) <= 1.0 + 1e-4
    with pytest.raises(ValueError, match="prob"):
        trender.make_frame_renderer((H, W, FOCAL), tf, cfg,
                                    maps=("rgb", "prob"), device="cpu", **KW)
    assert trender.LIGHT_MAPS == jrender.LIGHT_MAPS
    assert trender.HEAVY_MAPS == jrender.HEAVY_MAPS


@pytest.mark.parametrize("save_dir", [None, "/tmp/x"])
@pytest.mark.parametrize("save_alpha", [False, True])
def test_maps_for_save_equals_jax(save_dir, save_alpha):
    assert (trender.maps_for_save(save_dir, save_alpha)
            == jrender.maps_for_save(save_dir, save_alpha))


def test_render_frame_and_param_renderer_read_current_fields(fields):
    """`render_frame` is one frame of `make_frame_renderer`; the fields
    renderer reads the modules' parameters at each call."""
    _, tf = fields
    cfg = RenderConfig(**CFG)
    c2w = _poses()[1]
    one = trender.render_frame(c2w, (H, W, FOCAL), tf, cfg, device="cpu",
                               **KW)
    mods = torch.nn.ModuleDict({"coarse": tf})
    renderer = trender.make_param_frame_renderer((H, W, FOCAL), mods, cfg,
                                                 device="cpu", **KW)
    np.testing.assert_array_equal(renderer(c2w)["rgb"], one["rgb"])
    saved = tf.rgb_head.bias.detach().clone()
    with torch.no_grad():
        tf.rgb_head.bias.add_(1.0)
    try:
        assert not np.array_equal(renderer(c2w)["rgb"], one["rgb"])
    finally:
        with torch.no_grad():
            tf.rgb_head.bias.copy_(saved)


# --- metrics -----------------------------------------------------------------

def _images(seed, shape=(40, 36, 3)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + rng.randn(*shape) * 0.1, 0, 1).astype(np.float32)
    mask = (rng.rand(*shape[:2]) > 0.5).astype(np.float32)
    return a, b, mask


@pytest.mark.parametrize("masked", [False, True])
def test_psnr_matches_jax(masked):
    a, b, mask = _images(0)
    m = mask if masked else None
    got = float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b),
                              None if m is None else torch.from_numpy(m)))
    want = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b),
                               None if m is None else jnp.asarray(m)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("shape", [(40, 36, 3), (30, 33)])
@pytest.mark.parametrize("masked", [False, True])
def test_ssim_matches_jax(shape, masked):
    """f32 in both (JAX's conv at HIGHEST precision, the port's exact f32
    products): SSIM within 1e-6."""
    a, b, mask = _images(1, shape)
    m = mask if masked else None
    got = float(tmetrics.ssim(torch.from_numpy(a), torch.from_numpy(b),
                              mask=None if m is None else torch.from_numpy(m)))
    want = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b),
                               mask=None if m is None else jnp.asarray(m)))
    assert abs(got - want) <= 1e-6


def test_mask_metrics_and_to8b_match_jax():
    rng = np.random.RandomState(2)
    pred, gt = rng.rand(20, 24), rng.rand(20, 24)
    got = tmetrics.mask_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.mask_metrics(jnp.asarray(pred), jnp.asarray(gt))
    for k in ("accuracy", "iou"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, k
    x = np.array([[np.nan, 0.5], [2.0, -1.0], [0.999, 0.004]])
    np.testing.assert_array_equal(tmetrics.to8b(x), jmetrics.to8b(x))


# --- files -------------------------------------------------------------------

@pytest.mark.parametrize("channels", [0, 3])
def test_write_png_decodes_with_cv2(tmp_path, channels):
    rng = np.random.RandomState(3)
    shape = (17, 23) if channels == 0 else (17, 23, 3)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    trender.write_png(tmp_path / "a.png", img)
    back = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
    if channels:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, img)
    with pytest.raises(ValueError):
        trender.write_png(tmp_path / "b.png", img.astype(np.float32))


def test_write_video_falls_back_to_pngs_without_imageio_and_cv2(
        tmp_path, monkeypatch):
    """The card's machine has neither library: the chain ends in per-frame
    PNGs next to the requested path."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = np.random.RandomState(4).rand(3, 10, 12)
    trender.write_video(tmp_path / "disp.mp4", frames)
    out = tmp_path / "disp.mp4.frames"
    assert sorted(p.name for p in out.iterdir()) == [
        "0000.png", "0001.png", "0002.png"]
    back = cv2.imread(str(out / "0001.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., 0], tmetrics.to8b(frames[1]))
    assert not Path(tmp_path / "disp.mp4").exists()


def test_normalize_disps_for_video_matches_jax():
    d = np.random.RandomState(5).rand(3, 8, 9).astype(np.float32)
    d[0, 0, 0] = np.nan
    np.testing.assert_array_equal(trender.normalize_disps_for_video(d),
                                  jrender.normalize_disps_for_video(d))
