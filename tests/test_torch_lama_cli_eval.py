"""The LaMa evaluation commands of the port's command line against the
JAX package's on the same directories, with `device="cpu"`:

- `eval_inpainting --fid` (the random InceptionV3, equal in both
  packages): the TSV's SSIM / PSNR within 1e-4 and the Fréchet distance
  within 1e-3 relative, the per-image JSON within 1e-5;
- `side_by_side`, `analyze_errors`, `inner_features` (a tiny generator
  patched into both packages' loader) and `report`: the same files and
  text (TSV values within 1e-4);
- `export`: the TorchScript file reloads and gives the module's output
  (the JAX package writes StableHLO there)."""
import json

import numpy as np
import pytest
import torch

from spinnerf_tpu.cli.__main__ import main as jmain
from spinnerf_tpu_torch.cli.__main__ import main

from test_torch_lama_cli import same_tree
from test_torch_lama_tools import make_eval_dataset, rel, tiny_generators

torch.set_num_threads(1)


def tsv_close(a, b, *, fid_rtol=1e-3, atol=1e-4):
    """Two results TSVs: the same rows and columns, values within `atol`
    (the Fréchet rows within `fid_rtol` relative)."""
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    assert len(la) == len(lb) and la[0] == lb[0]
    for x, y in zip(la[1:], lb[1:]):
        cx, cy = x.split("\t"), y.split("\t")
        assert cx[0] == cy[0] and len(cx) == len(cy)
        for u, v in zip(cx[1:], cy[1:]):
            assert bool(u) == bool(v)
            if u:
                tol = (fid_rtol * abs(float(v)) + atol
                       if cx[0].startswith(("fid", "ssim_fid")) else atol)
                assert abs(float(u) - float(v)) <= tol, (cx[0], u, v)
    return la


@pytest.fixture()
def eval_dirs(tmp_path):
    return make_eval_dataset(tmp_path / "ds", n=4)


def test_eval_inpainting_fid_matches_jax(eval_dirs, tmp_path):
    data, pred = eval_dirs
    argv = ["eval_inpainting", "--datadir", str(data), "--predictdir",
            str(pred), "--fid"]
    assert jmain(argv + ["--outpath", str(tmp_path / "j.tsv")]) == 0
    assert main(argv + ["--outpath", str(tmp_path / "t.tsv")],
                device="cpu") == 0
    tl = tsv_close(tmp_path / "t.tsv", tmp_path / "j.tsv")
    assert any(line.startswith("fid_random_inception") for line in tl)
    jr, tr = (json.loads((tmp_path / f"{d}.tsv.per_image.json").read_text())
              for d in "jt")
    for a, b in zip(tr, jr):
        assert a["name"] == b["name"]
        assert abs(a["ssim"] - b["ssim"]) <= 1e-5
        assert abs(a["psnr"] - b["psnr"]) <= 1e-5 * b["psnr"]


def test_side_by_side_matches_jax(eval_dirs, tmp_path):
    data, pred = eval_dirs
    argv = ["side_by_side", "--datadir", str(data), "--max_n", "3",
            "--black"]
    assert jmain(argv + ["--outdir", str(tmp_path / "j"), str(pred)]) == 0
    assert main(argv + ["--outdir", str(tmp_path / "t"), str(pred)],
                device="cpu") == 0
    assert len(same_tree(tmp_path / "j", tmp_path / "t", tol=1)) == 3


def test_analyze_errors_matches_jax(eval_dirs, tmp_path):
    data, pred = eval_dirs
    argv = ["analyze_errors", "--datadir", str(data), "--predictdir",
            str(pred), "--worst_k", "2", "--sort_by", "psnr"]
    assert jmain(argv + ["--outdir", str(tmp_path / "j")]) == 0
    assert main(argv + ["--outdir", str(tmp_path / "t")], device="cpu") == 0
    names = same_tree(tmp_path / "j", tmp_path / "t", tol=1)
    assert len([n for n in names if n.startswith("worst_psnr")]) == 2
    tsv_close(tmp_path / "t" / "metrics.tsv", tmp_path / "j" / "metrics.tsv")
    assert (tmp_path / "t" / "report.html").read_text() == \
        (tmp_path / "j" / "report.html").read_text()


def test_inner_features_matches_jax(eval_dirs, tmp_path, monkeypatch):
    data, _ = eval_dirs
    (jgen, v), tgen = tiny_generators(1)
    import spinnerf_tpu.pipeline.inpaint2d as jinp2d
    import spinnerf_tpu_torch.pipeline.inpaint2d as tinp2d
    monkeypatch.setattr(jinp2d, "load_generator", lambda *a, **k: (jgen, v))
    monkeypatch.setattr(tinp2d, "load_generator", lambda *a, **k: tgen)
    argv = ["inner_features", "--indir", str(data)]
    assert jmain(argv + ["--outdir", str(tmp_path / "j")]) == 0
    assert main(argv + ["--outdir", str(tmp_path / "t")], device="cpu") == 0
    for n in same_tree(tmp_path / "j", tmp_path / "t", tol=1):
        if n.endswith(".npy"):
            assert rel(np.load(tmp_path / "t" / n),
                       np.load(tmp_path / "j" / n)) < 1e-5


def test_report_matches_jax(tmp_path, capsys):
    p = tmp_path / "metrics.jsonl"
    p.write_text("".join(json.dumps({"step": i, "g_l1": 2.0 / (i + 1),
                                     "d_total": 0.7 + 0.01 * i}) + "\n"
                         for i in range(6)))
    assert jmain(["report", str(p)]) == 0
    want = capsys.readouterr().out
    assert main(["report", str(p)], device="cpu") == 0
    assert capsys.readouterr().out == want
    assert "g_l1" in want


def test_export_writes_a_traced_generator(tmp_path, monkeypatch):
    (jgen, v), tgen = tiny_generators(2)
    import spinnerf_tpu.pipeline.inpaint2d as jinp2d
    import spinnerf_tpu_torch.pipeline.inpaint2d as tinp2d
    monkeypatch.setattr(jinp2d, "load_generator", lambda *a, **k: (jgen, v))
    monkeypatch.setattr(tinp2d, "load_generator", lambda *a, **k: tgen)
    argv = ["export", "--height", "32", "--width", "48"]
    assert jmain(argv + ["--outpath", str(tmp_path / "gen.stablehlo")]) == 0
    assert main(argv + ["--outpath", str(tmp_path / "gen.pt")],
                device="cpu") == 0
    assert (tmp_path / "gen.stablehlo").stat().st_size > 0
    traced = torch.jit.load(str(tmp_path / "gen.pt"))
    x = torch.rand(1, 4, 32, 48, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(traced(x), tgen(x))
