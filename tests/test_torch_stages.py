"""The port's pipeline stages (`spinnerf_tpu_torch/pipeline/stages.py`) on
the CPU: `stage_fit` then `stage_eval` on a 64 x 80 scene written by the
port's `make_scene` (two object-removed ground-truth views, `label_full/`
hole masks, 16 x 20 LPIPS patches at factors 2 and 2), whose eval rows
equal the JAX package's `metrics.psnr` / `metrics.ssim` and LPIPS on the
same rendered arrays within 1e-5 (relative; SSIM, in [-1, 1], absolute),
with random VGG16 weights dropped into `SPINNERF_WEIGHTS_DIR` in
torchvision's format behind both; the fit's sanity panel at i_feat;
`stage_prepare`'s dump; `stage_inpaint_guidance` against the JAX stage
with one tiny generator behind both (files and pixels within 1 LSB);
`run_pipeline` with and without MVSeg on a 32 x 40 scene (the JAX
package's pipeline contract), and through `pipeline --mesh_shape 2` on
two gloo ranks; and `write_gallery` and the weights
registry's `find` match the JAX package's."""
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


def _tiny_generators(monkeypatch):
    """Both packages' `load_generator` patched to one tiny generator (JAX's
    seeded variables, carried to the port)."""
    from spinnerf_tpu.models import lama as jlama
    from spinnerf_tpu.pipeline import inpaint2d as jinp
    from spinnerf_tpu_torch.convert import lama_state_dict
    from spinnerf_tpu_torch.models import lama as tlama
    from spinnerf_tpu_torch.pipeline import inpaint2d as tinp
    tiny = dict(ngf=8, n_blocks=2, max_features=64)
    gen = jlama.FFCResNetGenerator(**tiny)
    v = jax.tree.map(np.asarray, jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4))))
    tgen = tlama.FFCResNetGenerator(**tiny, device="cpu")
    tgen.load_state_dict(lama_state_dict(v), strict=True)
    monkeypatch.setattr(jinp, "load_generator",
                        lambda checkpoint_path=None, **kw: (gen, v))
    monkeypatch.setattr(tinp, "load_generator",
                        lambda checkpoint_path=None, device=None, **kw:
                        tgen.requires_grad_(False))


def test_inpaint_guidance_matches_jax(tmp_path, monkeypatch):
    """Stage 4 of both packages on copies of one scene and one prepare
    dump: the same files in depth/ and lama_images/, pixels within 1
    LSB."""
    import cv2
    import shutil
    from spinnerf_tpu.config import Config as JConfig
    from spinnerf_tpu.pipeline import stages as jstages
    from spinnerf_tpu_torch.eval.render import write_png
    _tiny_generators(monkeypatch)
    src = synthetic.make_scene(tmp_path / "scene", n_views=4, h=32, w=40,
                               factor=1, n_points=100)
    for sub in ("depth", "lama_images"):
        shutil.rmtree(src / "images" / sub)
    lama_in = tmp_path / "lama_in"
    (lama_in / "label").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(lama_in / f"img{i:03d}.png",
                  (rng.rand(32, 40) * 255).astype(np.uint8))
        write_png(lama_in / "label" / f"img{i:03d}.png",
                  read_png(src / "images" / "label" / f"view{i:03d}.png"))
    dirs = {}
    for tag, cls, stage_fn, kw in (
            ("port", Config, stages.stage_inpaint_guidance,
             dict(device="cpu")),
            ("jax", JConfig, jstages.stage_inpaint_guidance, {})):
        scene = shutil.copytree(src, tmp_path / f"scene_{tag}")
        cfg = cls(expname="g", basedir=str(tmp_path / f"logs_{tag}"),
                  datadir=str(scene), factor=1)
        dirs[tag] = stage_fn(cfg, lama_in, log=lambda *a: None, **kw)
    assert dirs["port"][0] == tmp_path / "scene_port" / "images" / "depth"
    for got, want in zip(dirs["port"], dirs["jax"]):
        names = sorted(p.name for p in want.glob("*.png"))
        assert names == [f"view{i:03d}.png" for i in range(4)]
        assert sorted(p.name for p in got.glob("*.png")) == names
        for n in names:
            a = read_png(got / n).astype(int)
            b = cv2.cvtColor(cv2.imread(str(want / n)), cv2.COLOR_BGR2RGB)
            assert np.abs(a - b).max() <= 1, (got.name, n)


@pytest.mark.parametrize("skip_mvseg", [True, False])
def test_run_pipeline_writes_the_scene_contract(tmp_path, skip_mvseg):
    """`run_pipeline` on a 32 x 40 scene on the CPU, the JAX package's
    `test_pipeline.py` contract (JAX's own run is a slow test): every
    stage's products, `stage_seconds` and `pipeline_results.json`. The
    default generator (seeded big-lama) does the guidance."""
    import json
    import shutil
    scene = synthetic.make_scene(tmp_path / "scene", n_views=5, h=32, w=40,
                                 factor=1, n_points=100,
                                 mask_views=[0, 1, 2, 3, 4])
    img_dir = scene / "images"
    for sub in ("depth", "lama_images"):
        shutil.rmtree(img_dir / sub)
    labels = {p.name: p.read_bytes() for p in (img_dir / "label").iterdir()}
    cfg = Config(expname="pipe", basedir=str(tmp_path / "logs"),
                 datadir=str(scene), factor=1, no_ndc=True, no_tcnn=True,
                 netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
                 multires=4, multires_views=2, N_samples=8, N_importance=4,
                 N_rand=64, lrate=5e-3, lrate_decay=250, i_print=0,
                 i_weights=0, i_video=0, i_testset=0, i_feat=1, chunk=2048,
                 compute_dtype="float32", render_factor=1, N_gt=1,
                 lpips_render_factor=1, patch_len_factor=2,
                 lpips_batch_size=1, mask_dilate_iters=1)
    trainer, results = stages.run_pipeline(
        cfg, mvseg_iters=10, prepare_iters=10, fit_iters=10, refine=False,
        skip_mvseg=skip_mvseg, log=lambda *a: None, device="cpu")
    names = [f"view{i:03d}.png" for i in range(5)]
    for sub in ("label", "depth", "lama_images"):
        assert sorted(p.name for p in (img_dir / sub).glob("*.png")) == \
            names, sub
    for n in names:
        assert read_png(img_dir / "lama_images" / n).shape == (32, 40, 3)
    # MVSeg rewrites label/ only when it runs
    rewritten = any(labels[n] != (img_dir / "label" / n).read_bytes()
                    for n in names)
    assert rewritten == (not skip_mvseg)
    assert (tmp_path / "logs" / "pipe_mvseg").exists() == (not skip_mvseg)
    assert trainer.step == 10 and trainer.cfg.expname == "pipe_fit"
    assert np.isfinite(results["summary"]["psnr"])
    want = {"prepare", "inpaint_guidance", "fit", "eval"} | (
        set() if skip_mvseg else {"mvseg"})
    assert set(results["stage_seconds"]) == want
    assert all(t >= 0 for t in results["stage_seconds"].values())
    out = json.loads((tmp_path / "logs" / "pipe" /
                      "pipeline_results.json").read_text())
    assert out == json.loads(json.dumps(results))


def test_run_pipeline_on_two_ranks(tmp_path, capfd):
    """`pipeline --mesh_shape 2` on the CPU (two gloo ranks launched by the
    command line): MVSeg, prepare and the fit train data-parallel, the mask
    export, the LaMa guidance and the eval run on rank 0, which alone
    logs and writes; the scene contract as on one rank."""
    import json
    import shutil

    from spinnerf_tpu_torch.cli.__main__ import main
    scene = synthetic.make_scene(tmp_path / "scene", n_views=5, h=32, w=40,
                                 factor=1, n_points=100,
                                 mask_views=[0, 1, 2, 3, 4])
    img_dir = scene / "images"
    for sub in ("depth", "lama_images"):
        shutil.rmtree(img_dir / sub)
    flags = dict(expname="pipe", basedir=tmp_path / "logs", datadir=scene,
                 factor=1, no_ndc=True, no_tcnn=True, netdepth=2,
                 netwidth=32, netdepth_fine=2, netwidth_fine=32, multires=4,
                 multires_views=2, N_samples=8, N_importance=4, N_rand=64,
                 lrate=5e-3, lrate_decay=250, i_print=5, i_weights=0,
                 i_video=0, i_testset=0, i_feat=0, chunk=2048,
                 compute_dtype="float32", render_factor=1, N_gt=1,
                 lpips_render_factor=1, patch_len_factor=2,
                 lpips_batch_size=1, mask_dilate_iters=1, mesh_shape=2,
                 mvseg_iters=10, prepare_iters=10, fit_iters=10)
    argv = ["pipeline", "--no_refine"] + [
        a for k, v in flags.items() for a in (f"--{k}", str(v))]
    assert main(argv, device="cpu") == 0
    names = [f"view{i:03d}.png" for i in range(5)]
    for sub in ("label", "depth", "lama_images"):
        assert sorted(p.name for p in (img_dir / sub).glob("*.png")) == \
            names, sub
    out = json.loads((tmp_path / "logs" / "pipe" /
                      "pipeline_results.json").read_text())
    assert set(out["stage_seconds"]) == {"mvseg", "prepare",
                                         "inpaint_guidance", "fit", "eval"}
    assert np.isfinite(out["summary"]["psnr"])
    text = capfd.readouterr().out
    for stage in ("mvseg", "prepare", "inpaint_guidance", "fit", "eval"):
        assert text.count(f"[pipeline] stage {stage}:") == 1, stage
    # rank 0's log of the three trainers
    assert text.count("[5/10] loss") == 3
    assert text.count("[10] 2 ranks, parameters bit-equal across ranks") \
        == 3


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
