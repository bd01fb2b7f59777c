"""The LaMa training commands of the port's command line
(`python -m spinnerf_tpu_torch.cli <command>`) against the JAX package's
on the same directories, with `device="cpu"`:

- `gen_masks` for every `--kind`: the same files, pixel for pixel (`segm`
  from one pair of MIT ADE20k files in `$SPINNERF_WEIGHTS_DIR`);
- `lama_train` from JAX's initial state (carried across by
  `convert.lama_train_state` where the port would draw its own): the same
  files but the checkpoints (orbax's directory there, a `torch.save` file
  here), the step-0 metrics within 1e-5 relative, the last step's and the
  validation rows within 1e-3, the EMA grid within 1 / 255.

`tests/test_torch_lama_cli_eval.py` runs the evaluation commands."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.cli.__main__ import main as jmain
from spinnerf_tpu.models import segmentation as jseg
from spinnerf_tpu.models.discriminator import NLayerDiscriminator as JD
from spinnerf_tpu.models.lama import FFCResNetGenerator as JG
from spinnerf_tpu.train import lama_trainer as jt
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.cli.__main__ import main
from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.models import segmentation as tseg
from spinnerf_tpu_torch.train import lama_loop

from test_torch_lama_tools import rel

torch.set_num_threads(1)


def images_dir(root, n=3, hw=(64, 80), seed=0):
    """Smooth images with a few blobs (PNG)."""
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True)
    yy, xx = np.mgrid[:hw[0], :hw[1]] / np.array(hw).reshape(2, 1, 1)
    for i in range(n):
        img = np.stack([yy, xx, 0.5 + 0.2 * np.sin(6 * (yy + xx))], -1)
        for _ in range(3):
            cy, cx, r = rng.rand(), rng.rand(), 0.08 + 0.1 * rng.rand()
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[blob] = rng.rand(3)
        write_png(root / f"view{i:03d}.png", (img * 255).astype(np.uint8))
    return root


def same_tree(a, b, tol=0):
    names = sorted(p.name for p in a.iterdir())
    assert sorted(p.name for p in b.iterdir()) == names and names
    for n in names:
        if n.endswith(".png"):
            x, y = read_png(a / n).astype(int), read_png(b / n).astype(int)
            assert x.shape == y.shape and np.abs(x - y).max() <= tol, n
    return names


@pytest.fixture(scope="module")
def segm_weights(tmp_path_factory):
    """MIT-format depth-50 encoder and decoder files, from the JAX
    package's random init carried across."""
    d = tmp_path_factory.mktemp("weights")
    model = jseg.SegmentationModel(depth=50)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3))))
    tm = tseg.SegmentationModel(50, device="cpu")
    tm.load_state_dict(convert.segmentation_state_dict(v), strict=True)
    torch.save(tm.encoder.state_dict(), d / "ade20k_resnet50.pth")
    torch.save(tm.decoder.state_dict(), d / "ade20k_ppm_decoder.pth")
    return d


@pytest.mark.parametrize("kind", ["mixed", "irregular", "rectangle",
                                  "outpainting", "dumb", "superres",
                                  "squares", "segm"])
def test_gen_masks_matches_jax(kind, tmp_path, monkeypatch, request):
    src = images_dir(tmp_path / "src")
    if kind == "segm":
        monkeypatch.setenv("SPINNERF_WEIGHTS_DIR",
                           str(request.getfixturevalue("segm_weights")))
    argv = ["gen_masks", "--indir", str(src), "--kind", kind, "--n_masks",
            "2", "--seed", "1"]
    assert jmain(argv + ["--outdir", str(tmp_path / "j")]) == 0
    assert main(argv + ["--outdir", str(tmp_path / "t")],
                device="cpu") == 0
    names = same_tree(tmp_path / "j", tmp_path / "t")
    if kind != "segm":
        assert len(names) == 9          # 3 images, 2 masks each
        for n in names:
            if "_mask" in n:
                assert read_png(tmp_path / "t" / n).max() == 255


def test_lama_train_matches_jax(tmp_path, monkeypatch, capsys):
    src = images_dir(tmp_path / "src", n=4, hw=(40, 48))
    val = tmp_path / "val"
    assert jmain(["gen_masks", "--indir", str(images_dir(
        tmp_path / "vsrc", n=2, hw=(32, 40), seed=1)), "--outdir",
        str(val)]) == 0
    gk = dict(ngf=8, n_blocks=1)
    jinit, _ = jt.make_lama_train_step(JG(**gk), JD())
    jstate = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0),
                                            image_shape=(2, 32, 32, 3)))
    make = lama_loop.make_lama_train_step

    def from_jax(gen, disc, **kw):
        init_fn, step_fn = make(gen, disc, **kw)
        return (lambda seed=0: convert.lama_train_state(jstate,
                                                        init_fn(seed)),
                step_fn)
    monkeypatch.setattr(lama_loop, "make_lama_train_step", from_jax)
    argv = ["lama_train", "--indir", str(src), "--n_steps", "3",
            "--batch_size", "2", "--crop", "32", "--ngf", "8",
            "--n_blocks", "1", "--val_dir", str(val), "--i_val", "1"]
    assert jmain(argv + ["--exp_dir", str(tmp_path / "j")]) == 0
    assert main(argv + ["--exp_dir", str(tmp_path / "t")],
                device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("training images from") == 2
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    same_tree(tmp_path / "j" / "visualizations",
              tmp_path / "t" / "visualizations", tol=1)
    assert (tmp_path / "t" / "checkpoints" / "ckpt_00000002.pt").exists()
    jrows, trows = ([json.loads(line) for line in
                     (tmp_path / d / "metrics.jsonl").read_text()
                     .splitlines()] for d in ("j", "t"))
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == \
        [0, 1, 2, 2]
    for j, t in zip(jrows, trows):
        assert set(t) == set(j)
        if "val" in j:
            for k in ("ssim", "psnr"):
                assert rel(t["val"][k]["mean"], j["val"][k]["mean"]) < 1e-3
        else:
            tol = 1e-5 if j["step"] == 0 else 1e-3
            for k in j:
                assert rel(t[k], j[k]) < tol, (j["step"], k)
