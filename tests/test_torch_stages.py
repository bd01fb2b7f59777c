"""The port's pipeline stages (`spinnerf_tpu_torch/pipeline/stages.py`) on
the CPU: `stage_fit` then `stage_eval` on a 64 x 80 scene written by the
port's `make_scene` (two object-removed ground-truth views, `label_full/`
hole masks, 16 x 20 LPIPS patches at factors 2 and 2), whose eval rows
equal the JAX package's `metrics.psnr` / `metrics.ssim` and LPIPS on the
same rendered arrays within 1e-5 (relative; SSIM, in [-1, 1], absolute),
with random VGG16 weights dropped into `SPINNERF_WEIGHTS_DIR` in
torchvision's format behind both; the fit's sanity panel at i_feat;
`stage_prepare`'s dump; the stages still to port raise, naming
ROADMAP.md; and `write_gallery` and the weights registry's `find` match
the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.eval import metrics as jmetrics
from spinnerf_tpu.models import lpips as jlpips
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import synthetic
from spinnerf_tpu_torch.eval.render import read_png
from spinnerf_tpu_torch.pipeline import stages

torch.set_num_threads(1)

# torchvision's VGG16 `features` index of each of the 13 convolutions
TV_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return synthetic.make_scene(tmp_path_factory.mktemp("scene"), n_views=6,
                                h=64, w=80, factor=1, n_points=300, n_gt=2,
                                gt_mask_subdir="label_full")


def _cfg(tmp_path, scene_dir, **kw):
    base = dict(expname="st", basedir=str(tmp_path), datadir=str(scene_dir),
                factor=1, no_ndc=True, log2_hashmap_size=13, N_samples=12,
                N_importance=6, N_rand=64, lrate=1e-2, i_print=0,
                i_weights=0, i_video=0, i_testset=0, i_feat=20,
                compute_dtype="float32", N_gt=2,
                masks_gt_subdir="label_full", lpips_render_factor=2,
                patch_len_factor=2, lpips_batch_size=2, colmap_depth=True,
                depth_loss=True)
    base.update(kw)
    return Config(**base)


def _drop_weights(d, seed=0):
    """Random lecun-scaled VGG16 weights (torchvision's `features.*`) and
    non-negative heads (`lin{i}.model.1.weight`) in `d`; returns the paths
    for the JAX loader."""
    rng = np.random.RandomState(seed)
    sd, c_in = {}, 3
    for idx, ch in zip(TV_CONV_INDEX, (64,) * 2 + (128,) * 2 + (256,) * 3
                       + (512,) * 6):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(ch, c_in, 3, 3) / np.sqrt(9 * c_in)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.zeros(ch)
        c_in = ch
    torch.save(sd, d / "vgg16.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
        rng.rand(1, c, 1, 1).astype(np.float32) / c)
        for i, c in enumerate((64, 128, 256, 512, 512))},
        d / "lpips_vgg_lin.pth")
    return str(d / "vgg16.pth"), str(d / "lpips_vgg_lin.pth")


def test_fit_then_eval_match_jax_metrics(scene_dir, tmp_path, monkeypatch):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    monkeypatch.setenv("SPINNERF_WEIGHTS_DIR", str(wdir))
    jlp = jax.jit(jlpips.load_lpips(*_drop_weights(wdir)))
    cfg = _cfg(tmp_path, scene_dir)
    tr = stages.stage_fit(cfg, n_iters=20, device="cpu", log=lambda *a: None)
    assert tr.step == 20 and tr.cfg.expname == "st_fit"
    assert tr.cfg.lpips and not tr.cfg.prepare
    assert list(tr.i_test) == [0, 1]
    m = tr.step_fn(21)
    assert float(m["lpips_loss"]) == 0.0 and np.isfinite(float(m["loss"]))
    # the panel at i_feat
    panel = read_png(tr.exp_dir / "test_renders" / "st_fit_000020.png")
    assert panel.shape == (64, 240, 3)

    res = stages.stage_eval(cfg, tr, log=lambda *a: None)
    rows = res["per_view"]
    assert len(rows) == 2
    rgbs, _ = tr.render_poses_list(tr.scene.poses[tr.i_test])
    for row, r, t in zip(rows, rgbs, tr.i_test):
        pred = jnp.asarray(r)
        gt = jnp.asarray(tr.scene.images[t])
        m = jnp.asarray((np.abs(tr.scene.masks_gt[t]) > 0.5)
                        .astype(np.float32))
        assert float(m.sum()) > 0
        comp = pred * m[..., None] + gt * (1.0 - m[..., None])
        want = {"psnr": jmetrics.psnr(pred, gt),
                "ssim": jmetrics.ssim(pred, gt),
                "lpips": jlp(pred, gt),
                "masked_psnr": jmetrics.psnr(pred, gt, m),
                "masked_ssim": jmetrics.ssim(pred, gt, mask=m),
                "masked_lpips": jlp(comp, gt)}
        assert set(row) == set(want)
        for k, v in want.items():
            assert np.isfinite(row[k]), k
            if k.endswith("ssim"):
                # a value in [-1, 1], held absolutely as in
                # test_torch_render.py: its E[x^2] - mu^2 terms lose ~1e-5 to
                # f32 cancellation on smooth renders in both packages (here
                # the port's is 1.2e-5 from float64, JAX's 4e-6)
                assert abs(row[k] - float(v)) < 1e-5, k
            else:
                assert rel(row[k], float(v)) < 1e-5, k
    for k, v in res["summary"].items():
        assert v == pytest.approx(np.mean([r[k] for r in rows]), rel=1e-12)


def test_eval_without_weights_is_random_vgg_and_skips_empty_masks(
        scene_dir, tmp_path, monkeypatch):
    """The key is lpips_random_vgg with no weights dropped in; a view whose
    mask is empty has no masked row; no test view, no rows."""
    monkeypatch.delenv("SPINNERF_WEIGHTS_DIR", raising=False)
    tr = stages.stage_fit(_cfg(tmp_path, scene_dir, i_feat=0), n_iters=1,
                          device="cpu", log=lambda *a: None)
    tr.scene.masks_gt[0] = 0.0
    res = stages.stage_eval(tr.cfg, tr, log=lambda *a: None)
    keys = [set(r) for r in res["per_view"]]
    assert keys[0] == {"psnr", "ssim", "lpips_random_vgg"}
    assert keys[1] == keys[0] | {"masked_psnr", "masked_ssim",
                                 "masked_lpips_random_vgg"}
    tr.i_test = np.array([], dtype=int)
    assert stages.stage_eval(tr.cfg, tr, log=lambda *a: None) == {}


def test_prepare_stage_dumps_the_guidance_inputs(scene_dir, tmp_path):
    out = stages.stage_prepare(_cfg(tmp_path, scene_dir, lpips=True),
                               n_iters=2, device="cpu", log=lambda *a: None)
    assert out == tmp_path / "st_prepare" / "lama_input"
    names = [f"img{i:03}.png" for i in range(6)]
    assert sorted(p.name for p in out.glob("*.png")) == names
    assert sorted(p.name for p in (out / "label").glob("*.png")) == names
    assert stages._images_dir(_cfg(tmp_path, scene_dir)) == scene_dir / \
        "images"
    assert stages._images_dir(_cfg(tmp_path, scene_dir, factor=4)) == \
        scene_dir / "images_4"


@pytest.mark.parametrize("fn,queue", [
    (lambda c: stages.stage_mvseg(c), "A5"),
    (lambda c: stages.stage_inpaint_guidance(c, None), "A6"),
    (lambda c: stages.run_pipeline(c), "A9")])
def test_unported_stages_raise(fn, queue):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue.*{queue}"):
        fn(Config())


def test_gallery_html_equals_jax(tmp_path):
    """`write_gallery` writes the JAX module's page byte for byte, escapes
    included."""
    from spinnerf_tpu.utils import visualization as jvis
    from spinnerf_tpu_torch.utils import visualization as tvis
    rows = [("view <0>", ["a.png", "b&c.png"]), (3, [tmp_path / "x'.png"])]
    mine = tvis.write_gallery(tmp_path / "t.html", rows, title="t<>t")
    theirs = jvis.write_gallery(tmp_path / "j.html", rows, title="t<>t")
    assert mine == tmp_path / "t.html"
    assert mine.read_text() == theirs.read_text()


def test_weights_find_matches_jax(tmp_path, monkeypatch):
    """Every well-known name resolves as in the JAX package: nothing without
    the directory, the primary file before an alternate, an alternate
    alone."""
    from spinnerf_tpu import weights as jweights
    from spinnerf_tpu_torch import weights as tweights
    assert tweights.WELL_KNOWN == jweights.WELL_KNOWN
    monkeypatch.delenv(tweights.ENV_VAR, raising=False)
    assert all(tweights.find(n) is None for n in tweights.WELL_KNOWN)
    monkeypatch.setenv(tweights.ENV_VAR, str(tmp_path))
    for name, (primary, alts) in tweights.WELL_KNOWN.items():
        (tmp_path / alts[-1]).write_bytes(b"")
        assert tweights.find(name) == jweights.find(name) == str(
            tmp_path / alts[-1])
        (tmp_path / primary).write_bytes(b"")
        assert tweights.find(name) == jweights.find(name) == str(
            tmp_path / primary)
