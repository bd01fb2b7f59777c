"""The port's inpainting evaluation and mask tools (`eval/inpainting.py`,
`eval/masks.py`, `pipeline/lama_tools.py`) against the JAX package's on the
same files, which the port reads and writes without cv2:

- `frechet_distance` equal to JAX's (the same float64 numpy / scipy);
  `InpaintingEvaluator` rows and tables within 1e-5, the VGG and the
  random-InceptionV3 Fréchet distances within 1e-3 relative (float32
  features of 2 images: the distance is a difference of large traces);
- `ObjectMask` and `LearnedMaskGenerator` (from one instances function)
  equal to JAX's masks; `ade20k_instances` from one pair of MIT files
  equal to JAX's instances; `propose_random_square_crop` equal;
- `score_predictions`, `side_by_side`, `analyze_errors`,
  `predict_inner_features`, `report_from_logs` / `format_report` and the
  TorchScript export (traced, reloaded, outputs equal to the module's)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.eval import inpainting as jinp
from spinnerf_tpu.eval import masks as jmasks
from spinnerf_tpu.models import lama as jlama
from spinnerf_tpu.models import lpips as jlpips
from spinnerf_tpu.pipeline import lama_tools as jtools
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.eval import inpainting as tinp
from spinnerf_tpu_torch.eval import masks as tmasks
from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.models import lama as tlama
from spinnerf_tpu_torch.pipeline import lama_tools as ttools

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def make_eval_dataset(root, seed=0, n=3, hw=(32, 40)):
    """A LaMa eval-layout directory and a prediction directory (one
    prediction at another size, INTER_AREA-resized when read)."""
    rng = np.random.RandomState(seed)
    data, pred = root / "data", root / "pred"
    data.mkdir(parents=True)
    pred.mkdir()
    h, w = hw
    for i in range(n):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        mask[y0:y0 + 4 + 4 * i, x0:x0 + 6 + 3 * i] = 255
        write_png(data / f"im{i}_crop000.png", img)
        write_png(data / f"im{i}_crop000_mask000.png", mask)
        noisy = np.clip(img.astype(np.int32) + rng.randint(-20, 20, img.shape),
                        0, 255).astype(np.uint8)
        if i == 1:
            noisy = noisy[::2, ::2].repeat(3, 0).repeat(3, 1)   # 48 x 60
        write_png(pred / f"im{i}_crop000_mask000.png", noisy)
    return data, pred


@pytest.fixture()
def eval_dataset(tmp_path):
    return make_eval_dataset(tmp_path)


def tiny_generators(seed=0):
    """JAX's tiny generator and the port's with its variables."""
    kw = dict(ngf=8, n_blocks=1, max_features=32)
    gen = jlama.FFCResNetGenerator(**kw)
    v = jax.tree.map(np.asarray, jax.jit(gen.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 4))))
    tgen = tlama.FFCResNetGenerator(**kw, device="cpu")
    tgen.load_state_dict(convert.lama_state_dict(v), strict=True)
    return (gen, v), tgen.requires_grad_(False)


def test_frechet_and_evaluator_match_jax():
    rng = np.random.RandomState(1)
    a, b = rng.randn(12, 6), rng.randn(12, 6) + 0.3
    assert tinp.frechet_distance(a, b) == jinp.frechet_distance(a, b)
    jev, tev = jinp.InpaintingEvaluator(), tinp.InpaintingEvaluator(
        device="cpu")
    for i in range(5):
        tgt = rng.rand(24, 32, 3).astype(np.float32)
        pred = np.clip(tgt + rng.randn(24, 32, 3) * 0.05 * (i + 1), 0,
                       1).astype(np.float32)
        mask = (rng.rand(24, 32) < 0.1 * i).astype(np.float32)
        jev.add(pred, tgt, mask)
        tev.add(pred, tgt, mask)
    want, got = jev.evaluation_end(), tev.evaluation_end()
    assert set(got) == set(want)
    for group in want:
        assert got[group]["n"] == want[group]["n"]
        for k, v in want[group].items():
            if isinstance(v, dict):
                for s in ("mean", "std"):
                    assert abs(got[group][k][s] - v[s]) <= 1e-5, (group, k)
    assert tinp.InpaintingEvaluator(device="cpu").evaluation_end() == \
        {"total": {"n": 0}}


def test_feature_extractors_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    imgs = rng.rand(2, 40, 48, 3).astype(np.float32)
    # one torchvision-format VGG16 file for both packages
    sd, c_in, idx = {}, 3, 0
    for ch, _, _ in jlpips._VGG_PLAN:
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(ch, c_in, 3, 3) / np.sqrt(9 * c_in)).astype(
                np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.randn(ch) * 0.01).astype(np.float32))
        c_in, idx = ch, idx + 2
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)
    want = jinp.FeatureExtractor(str(path))(imgs)
    got = tinp.FeatureExtractor(path, device="cpu")(imgs)
    assert got.shape == want.shape == (2, 64 + 128 + 256 + 512 + 512)
    assert rel(got, want) < 1e-5
    # the random InceptionV3: equal parameters, no conversion
    jfe = jinp.InceptionFeatureExtractor(batch=2)
    tfe = tinp.InceptionFeatureExtractor(batch=2, device="cpu")
    assert jfe.fid_key == tfe.fid_key == "fid_random_inception"
    fj, ft = jfe(imgs[:1]), tfe(imgs[:1])
    assert ft.shape == (1, 2048) and rel(ft, fj) < 1e-5


def test_object_mask_and_learned_generator_match_jax():
    rng = np.random.RandomState(3)
    h, w = 96, 128
    inst = []
    for k in range(4):
        m = np.zeros((h, w), bool)
        y, x = rng.randint(10, h - 30), rng.randint(10, w - 30)
        m[y:y + rng.randint(8, 25), x:x + rng.randint(8, 25)] = True
        inst.append(m)
    big = np.zeros((h, w), bool)
    big[:50] = True
    inst.append(big)
    for mode in ("rigid", "soft"):
        kw = dict(seed=4, rigidness_mode=getattr(jmasks.RigidnessMode, mode))
        a = jmasks.LearnedMaskGenerator(lambda im: inst, **kw).get_masks(
            np.zeros((h, w, 3)))
        kw["rigidness_mode"] = getattr(tmasks.RigidnessMode, mode)
        b = tmasks.LearnedMaskGenerator(lambda im: inst, **kw).get_masks(
            np.zeros((h, w, 3)))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for f in (0.6, 1.37):
        oj = jmasks.ObjectMask(inst[0]).rescale(f).shift(5, -7)
        ot = tmasks.ObjectMask(inst[0]).rescale(f).shift(5, -7)
        np.testing.assert_array_equal(oj.restore_full_mask(),
                                      ot.restore_full_mask())
    for s in range(5):
        assert jmasks.propose_random_square_crop(
            inst[s % 4], rng=np.random.RandomState(s)) == \
            tmasks.propose_random_square_crop(
                inst[s % 4], rng=np.random.RandomState(s))


def test_score_and_tsv_match_jax(eval_dataset, tmp_path):
    data, pred = eval_dataset
    assert [(a.name, b.name) for a, b in ttools.load_eval_pairs(data)] == \
        [(a.name, b.name) for a, b in jtools.load_eval_pairs(data)]
    jr, jrows = jtools.score_predictions(data, pred)
    tr, trows = ttools.score_predictions(data, pred, device="cpu")
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    for a, b in zip(trows, jrows):
        for k in ("ssim", "psnr", "mask_area"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), k
    ttools.write_results_tsv(tr, tmp_path / "t.tsv")
    jtools.write_results_tsv(jr, tmp_path / "j.tsv")
    assert (tmp_path / "t.tsv").read_text() == (tmp_path / "j.tsv").read_text()


def test_side_by_side_and_analyze_errors_match_jax(eval_dataset, tmp_path):
    data, pred = eval_dataset
    for black in (False, True):
        jo = jtools.side_by_side(data, [pred, pred], tmp_path / f"j{black}",
                                 black=black)
        to = ttools.side_by_side(data, [pred, pred], tmp_path / f"t{black}",
                                 black=black)
        names = sorted(p.name for p in jo.iterdir())
        assert sorted(p.name for p in to.iterdir()) == names
        for n in names:
            a, b = read_png(jo / n), read_png(to / n)
            assert a.shape == b.shape == (32, 120, 3)
            assert np.abs(a.astype(int) - b).max() <= 1
    jtools.analyze_errors(data, pred, tmp_path / "je", worst_k=2)
    ttools.analyze_errors(data, pred, tmp_path / "te", worst_k=2,
                          device="cpu")
    jrows = json.loads((tmp_path / "je" / "per_image.json").read_text())
    trows = json.loads((tmp_path / "te" / "per_image.json").read_text())
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    assert sorted(p.name for p in (tmp_path / "te").iterdir()) == \
        sorted(p.name for p in (tmp_path / "je").iterdir())
    assert (tmp_path / "te" / "metrics.tsv").read_text() == \
        (tmp_path / "je" / "metrics.tsv").read_text()


def test_inner_features_and_export(eval_dataset, tmp_path, monkeypatch):
    data, _ = eval_dataset
    (jgen, v), tgen = tiny_generators()
    import spinnerf_tpu.pipeline.inpaint2d as jinp2d
    import spinnerf_tpu_torch.pipeline.inpaint2d as tinp2d
    monkeypatch.setattr(jinp2d, "load_generator", lambda *a, **k: (jgen, v))
    monkeypatch.setattr(tinp2d, "load_generator", lambda *a, **k: tgen)
    jo = jtools.predict_inner_features(data, tmp_path / "jf", n_channels=4)
    to = ttools.predict_inner_features(data, tmp_path / "tf", n_channels=4,
                                       device="cpu")
    names = sorted(p.name for p in jo.iterdir())
    assert sorted(p.name for p in to.iterdir()) == names and len(names) == 6
    for n in names:
        if n.endswith(".npy"):
            a, b = np.load(jo / n), np.load(to / n)
            assert b.shape == a.shape and rel(b, a) < 1e-5
        else:
            assert np.abs(read_png(jo / n).astype(int)
                          - read_png(to / n)).max() <= 1
    out = ttools.export_generator(tmp_path / "gen.pt",
                                  input_shape=(1, 4, 32, 40), device="cpu")
    loaded = torch.jit.load(str(out))
    x = torch.rand(2, 4, 32, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(loaded(x), tgen(x))


def test_report_matches_jax(tmp_path):
    p = tmp_path / "metrics.jsonl"
    with open(p, "w") as f:
        for i in range(5):
            f.write(json.dumps({"step": i, "g_total": 1.0 - 0.1 * i,
                                "d_adv": 0.5 + 0.01 * i}) + "\n")
        f.write(json.dumps({"step": 4, "val": {"ssim": 0.5}}) + "\n")
    assert ttools.report_from_logs(p) == jtools.report_from_logs(p)
    assert ttools.format_report(ttools.report_from_logs(p)) == \
        jtools.format_report(jtools.report_from_logs(p))
    (tmp_path / "empty.jsonl").write_text("")
    assert ttools.report_from_logs(tmp_path / "empty.jsonl") == {}
