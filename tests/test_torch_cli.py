"""The port's command-line entry point (`spinnerf_tpu_torch/cli/__main__.py`)
and the modules only it reaches (`eval/cli.py`, `pipeline/poses.py`,
`train/checkpoints.py::strip_checkpoint`, `utils/renderpath.py`) against
the JAX package's `cli_main`, on the CPU (`main(..., device="cpu")`).

`train` then `render` at a toy size (hash grid 2^13, 32 x 40): the render
tree's contract, the `--render_mypath` poses within 1e-6 of JAX's
`generate_renderpath`, the `--render_test_ray` plot. `refine_masks`,
`eval` and `poses` run through both packages' CLIs on the same
directories: refined PNGs equal pixel for pixel, the eval JSON's PSNR and
SSIM within 1e-6 (relative above 1: they are f32 values) and LPIPS within
1e-5 relative (random torchvision-format VGG16 weights dropped in behind
both), `poses_bounds.npy` within 1e-6. A fake `colmap` on PATH records the
same commands from both packages.
"""
import json
import os
import shutil
import stat

import numpy as np
import pytest
import torch

from spinnerf_tpu.cli.__main__ import main as jax_main
from spinnerf_tpu.config import load_config as jax_load_config
from spinnerf_tpu.data import synthetic as jsynthetic
from spinnerf_tpu.pipeline import poses as jposes
from spinnerf_tpu.utils.renderpath import generate_renderpath as jax_orbit
from spinnerf_tpu_torch.cli.__main__ import main
from spinnerf_tpu_torch.config import load_config
from spinnerf_tpu_torch.data import dispatch, synthetic
from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.pipeline import poses
from spinnerf_tpu_torch.train.checkpoints import (CheckpointManager,
                                                  restore_from_path)
from test_torch_mask_refine import FOCAL, H, W, make_arrays

torch.set_num_threads(1)

TOY = ["--expname", "cli", "--factor", "1", "--no_ndc", "True",
       "--log2_hashmap_size", "13", "--N_samples", "8", "--N_importance",
       "4", "--N_rand", "64", "--N_iters", "12", "--i_print", "1000",
       "--i_weights", "10", "--i_video", "0", "--i_testset", "0",
       "--i_feat", "0", "--chunk", "2048", "--N_gt", "1"]
TV_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    scene = synthetic.make_scene(tmp / "scene", n_views=5, h=32, w=40,
                                 factor=1)
    args = TOY + ["--basedir", str(tmp / "logs"), "--datadir", str(scene)]
    assert main(["train"] + args, device="cpu") == 0
    return tmp, args


def test_help_and_unknown_command(capsys):
    assert main(["--help"]) == 0
    assert "python -m spinnerf_tpu_torch.cli" in capsys.readouterr().out
    assert main([]) == 0
    capsys.readouterr()
    assert main(["no_such_command"]) == 2
    assert "unknown command: no_such_command" in capsys.readouterr().err


def test_train_needs_the_card_unless_cpu_is_asked(trained):
    tmp, args = trained
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train"] + args)


def test_load_config_matches_jax(tmp_path):
    cfg_file = tmp_path / "config.txt"
    cfg_file.write_text("expname = fern\n# a comment\ndatadir = ./data/x\n"
                        "factor = 8\nN_rand = 2048\nlrate = 5e-4\n"
                        "no_ndc\nwhite_bkgd = True\nmvseg = False\n")
    argv = ["--config", str(cfg_file), "--N_rand", "512", "--lindisp",
            "--train_scene", "0", "2", "5", "--raw_noise_std", "1e0",
            "--expname", "x", "--colmap_depth", "True"]
    got, want = load_config(argv), jax_load_config(argv)
    got, want = vars(got), vars(want)
    assert got == want
    assert got["N_rand"] == 512 and got["factor"] == 8 and got["no_ndc"]


def test_pipeline_argument_split_matches_jax(monkeypatch):
    import spinnerf_tpu.pipeline.stages as jstages
    import spinnerf_tpu_torch.pipeline.stages as pstages
    seen = {}

    def fake(tag):
        def run_pipeline(cfg, **kw):
            seen[tag] = (vars(cfg), kw)
            return None, {"summary": {}}
        return run_pipeline
    monkeypatch.setattr(jstages, "run_pipeline", fake("jax"))
    monkeypatch.setattr(pstages, "run_pipeline", fake("port"))
    argv = ["pipeline", "--mvseg", "--mvseg_iters", "3", "--prepare",
            "True", "--prepare_iters", "4", "--fit_iters", "5",
            "--no_refine", "--lama_checkpoint", "big.ckpt", "--N_rand", "64"]
    assert jax_main(argv) == 0
    assert main(argv, device="cpu") == 0
    (jcfg, jkw), (pcfg, pkw) = seen["jax"], seen["port"]
    assert pkw.pop("device") == "cpu"
    assert pcfg == jcfg and pkw == jkw
    assert pcfg["mvseg"] and pcfg["prepare"] and pcfg["N_rand"] == 64
    assert pkw == dict(mvseg_iters=3, prepare_iters=4, fit_iters=5,
                       lama_checkpoint="big.ckpt", refine=False,
                       skip_mvseg=False)


def test_render_modes(trained, capsys):
    tmp, args = trained
    exp = tmp / "logs" / "cli"
    render = ["render"] + args + ["--render_only", "True"]
    assert main(render + ["--render_test", "True"], device="cpu") == 0
    out = exp / "renderonly_test_000010"
    _, i_train, i_test, *_ = dispatch.load_scene_for_config(
        load_config(args))
    for sub, ext in (("rgb", "png"), ("depth", "npy"), ("disp", "npy"),
                     ("weight", "npy"), ("z", "npy"), ("alpha", "npy"),
                     ("pose", "txt"), ("images", "png")):
        assert len(list((out / sub).glob(f"*.{ext}"))) == len(i_test), sub
    assert (out / "intrinsics.txt").exists()
    assert np.load(out / "alpha" / "000000.npy").shape == (32, 40, 12)

    assert main(render + ["--render_mypath", "True"], device="cpu") == 0
    scene, _, i_test, *_ = dispatch.load_scene_for_config(
        load_config(args))
    anchors = scene.poses[i_test][3:4]
    if len(anchors) == 0:
        anchors = scene.poses[i_test][:1]
    want = jax_orbit(anchors, scene.hwf[2], sc=1.0)
    got = np.stack([np.loadtxt(p)[:3] for p in sorted(
        (exp / "renderonly_mypath_000010" / "pose").glob("*.txt"))])
    assert got.shape == want.shape == (40, 3, 4)
    assert np.abs(got - want).max() <= 1e-6

    capsys.readouterr()
    assert main(render + ["--render_test_ray", "True"], device="cpu") == 0
    assert "estimated depth:" in capsys.readouterr().out
    plot = read_png(exp / "renderonly_ray_000010" / "rays.png")
    assert plot.shape == (480, 640, 3) and (plot != 255).any()


def test_strip_ckpt_round_trip(trained, tmp_path):
    tmp, args = trained
    exp = tmp / "logs" / "cli"
    assert main(["strip_ckpt", "--exp_dir", str(exp), "--out_dir",
                 str(tmp_path)], device="cpu") == 0
    path = tmp_path / "params_10.pt"
    step, restored = restore_from_path(path)
    full = torch.load(CheckpointManager(exp).path(10), weights_only=True)
    assert step == 10 and restored["opt_state"] is None
    assert restored["params"].keys() == full["params"].keys()
    for k, v in full["params"].items():
        assert torch.equal(restored["params"][k], v), k
    assert (tmp_path / "params_10.page_bounds.json").read_text() == \
        (exp / "page_bounds.json").read_text()
    # --ft_path and --alpha_model_path take the stripped file
    from spinnerf_tpu_torch.train.loop import Trainer
    cfg = load_config(args + ["--ft_path", str(path), "--expname", "ft",
                              "--alpha_model_path", str(path)])
    tr = Trainer(cfg, device="cpu", log=lambda *a: None)
    assert tr.step == 10
    for k, v in tr.fields.state_dict().items():
        assert torch.equal(v, full["params"][k]), k
    for k, v in tr.frozen.state_dict().items():
        assert torch.equal(v, full["params"]["fine." + k]), k
    with pytest.raises(FileNotFoundError):
        main(["strip_ckpt", "--exp_dir", str(exp), "--out_dir",
              str(tmp_path), "--step", "7"])


def _render_tree(root, arrays):
    """The `render_path` artifact tree of the analytic dumps."""
    for sub in ("rgb", "z", "alpha", "depth", "disp", "pose"):
        (root / sub).mkdir(parents=True)
    for i, a in enumerate(arrays):
        write_png(root / "rgb" / f"{i:06d}.png",
                  (a["image"] * 255).astype(np.uint8))
        for k in ("z", "alpha", "depth", "disp"):
            np.save(root / k / f"{i:06d}.npy", a[k])
        np.savetxt(root / "pose" / f"{i:06d}.txt", a["c2w"])
    np.savetxt(root / "intrinsics.txt",
               np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]]))


@pytest.fixture(scope="module")
def dumps_dir(tmp_path_factory):
    """The analytic render tree, the ball masks (undilated, as RGB PNGs)
    and the ball-free images of its views."""
    root = tmp_path_factory.mktemp("dumps")
    arrays = make_arrays(n_views=4, dilate=0)
    _render_tree(root / "render", arrays)
    (root / "masks").mkdir()
    (root / "gt").mkdir()
    for i, a in enumerate(arrays):
        m = (a["mask"] * 255).astype(np.uint8)
        write_png(root / "masks" / f"m{i}.png", np.stack([m] * 3, -1))
        rgb, _, _ = jsynthetic.render_view(a["c2w"][:3], H, W, FOCAL,
                                           with_ball=False)
        write_png(root / "gt" / f"{i:06d}.png",
                  (rgb * 255).astype(np.uint8))
    return root


def test_refine_masks_matches_jax(dumps_dir, tmp_path):
    argv = ["refine_masks", "--render_dir", str(dumps_dir / "render"),
            "--mask_dir", str(dumps_dir / "masks"), "--distance_thresh",
            "0.02", "--dilate_iters", "3"]
    assert jax_main(argv + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert main(argv + ["--out_dir", str(tmp_path / "port")],
                device="cpu") == 0
    names = [f"m{i}.png" for i in range(4)]
    for sub in ("refined_images", "refined_images/label", "refined_disp"):
        got = sorted(p.name for p in (tmp_path / "port" / sub).glob("*.png"))
        assert got == names
        for n in names:
            np.testing.assert_array_equal(
                read_png(tmp_path / "port" / sub / n),
                read_png(tmp_path / "jax" / sub / n))
    # the refinement un-masked part of the dilated masks
    from spinnerf_tpu_torch.data.llff import dilate_mask
    m0 = read_png(dumps_dir / "masks" / "m0.png")[..., 0] > 127
    dilated = dilate_mask(m0.astype(np.float32), iterations=3) > 0.5
    refined = read_png(tmp_path / "port" / "refined_images" / "label" /
                       "m0.png") > 127
    assert (refined <= dilated).all() and refined.sum() < dilated.sum()


def _drop_weights(d, seed=0):
    """Random VGG16 weights in torchvision's format and non-negative LPIPS
    heads in `d`."""
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


def test_eval_matches_jax(dumps_dir, tmp_path, monkeypatch):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    _drop_weights(wdir)
    monkeypatch.setenv("SPINNERF_WEIGHTS_DIR", str(wdir))
    argv = ["eval", "--pred_dir", str(dumps_dir / "render" / "rgb"),
            "--gt_dir", str(dumps_dir / "gt"), "--mask_dir",
            str(dumps_dir / "masks")]
    assert jax_main(argv + ["--json_out", str(tmp_path / "j.json")]) == 0
    assert main(argv + ["--json_out", str(tmp_path / "p.json")],
                device="cpu") == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert len(got["per_image"]) == len(want["per_image"]) == 4
    for g, w in zip(got["per_image"], want["per_image"]):
        assert g.keys() == w.keys() == {"name", "psnr", "ssim", "lpips",
                                        "masked_lpips"}
        assert g["name"] == w["name"]
        for k in ("psnr", "ssim"):     # f32 values: relative above 1
            assert abs(g[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1), \
                (k, g[k], w[k])
        for k in ("lpips", "masked_lpips"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g[k], w[k])
    # without the weights the port leaves LPIPS out (JAX scores a random VGG)
    monkeypatch.delenv("SPINNERF_WEIGHTS_DIR")
    assert main(argv[:5] + ["--json_out", str(tmp_path / "p2.json")],
                device="cpu") == 0
    rows = json.loads((tmp_path / "p2.json").read_text())["per_image"]
    assert all(r.keys() == {"name", "psnr", "ssim"} for r in rows)


def test_poses_matches_jax_and_the_scene(tmp_path):
    src = synthetic.make_scene(tmp_path / "s", n_views=4, h=24, w=32,
                               n_points=200)
    written = np.load(src / "poses_bounds.npy")
    shutil.copytree(src, tmp_path / "j")
    assert jax_main(["poses", str(tmp_path / "j")]) == 0
    assert main(["poses", str(src)]) == 0
    got = np.load(src / "poses_bounds.npy")
    assert got.shape == written.shape == (4, 17)
    assert np.abs(got - np.load(tmp_path / "j" / "poses_bounds.npy")).max() \
        <= 1e-6
    # the poses (not the bounds: those come from the sparse points) are
    # make_scene's
    assert np.abs(got[:, :15] - written[:, :15]).max() <= 1e-5


def _fake_colmap(bin_dir):
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text('#!/bin/sh\necho "$@" >> "$COLMAP_LOG"\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


def test_run_colmap_issues_the_jax_commands(tmp_path, monkeypatch):
    _fake_colmap(tmp_path / "bin")
    monkeypatch.setenv("PATH", str(tmp_path / "bin") + os.pathsep
                       + os.environ["PATH"])
    logs = {}
    for tag, fn in (("jax", jposes.run_colmap), ("port", poses.run_colmap)):
        scene = tmp_path / tag / "scene"
        (scene / "images").mkdir(parents=True)
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{tag}.log"))
        fn(scene, "sequential_matcher")
        logs[tag] = [(tmp_path / f"{tag}.log").read_text(),
                     (scene / "colmap_output.txt").read_text()]
        logs[tag] = [t.replace(str(scene), "<scene>") for t in logs[tag]]
    assert logs["port"] == logs["jax"]
    assert logs["port"][0].splitlines()[1] == \
        "sequential_matcher --database_path <scene>/database.db"
    # without the binary and without a sparse model, both raise
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not poses.colmap_available()
    for fn in (jposes.gen_poses, poses.gen_poses):
        with pytest.raises(RuntimeError, match="COLMAP binary not found"):
            fn(tmp_path / "port" / "scene")
