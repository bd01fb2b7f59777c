"""The port's full-scale pipeline tool (`python -m spinnerf_tpu_torch.tools.
full_run`) on the CPU: `--smoke` at 6 views and two steps a stage writes
the JAX tool's JSON layout (`summary` and `stage_seconds` keyed as the JAX
tool's `FULLRUN.json`, `config` keyed as the JAX tool's `main` writes it),
and the scene's resume marker reuses a finished scene and regenerates a
changed or unfinished one.

The smoke scene is 128 x 160 at factor 2 (64 x 80): the smoke
configuration's LPIPS patch is the frame over 2 x 2, and the port refuses a
patch side under 16 pixels (where the JAX package's LPIPS is NaN)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from spinnerf_tpu_torch.data import synthetic as tsynthetic
from spinnerf_tpu_torch.pipeline import stages as tstages
from spinnerf_tpu_torch.tools import full_run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--smoke", "--views", "6", "--gt", "2", "--h", "128", "--w", "160",
         "--iters-scale", "10000"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_full_run", ROOT / "tools" / "full_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_results(*_, **__):
    return None, {"summary": {"psnr": 1.0}, "stage_seconds": {"fit": 1.0},
                  "per_view": [{"psnr": 1.0}]}


def test_smoke_writes_the_jax_layout(tmp_path, monkeypatch):
    out = tmp_path / "smoke.json"
    assert full_run.main(SMOKE + ["--workdir", str(tmp_path / "w"),
                                  "--out", str(out)], device="cpu") == 0
    res = json.loads(out.read_text())
    ref = json.loads((ROOT / "FULLRUN.json").read_text())["mlp"]
    assert set(res) == {"summary", "stage_seconds", "config"}
    assert set(res["summary"]) == set(ref["summary"])
    assert all(np.isfinite(v) for v in res["summary"].values())
    assert list(res["stage_seconds"]) == list(ref["stage_seconds"])
    cfg = res["config"]
    assert cfg["iters"] == {"mvseg": 2, "prepare": 2, "fit": 2}
    assert cfg["train_res"] == [64, 80] and cfg["device"] == "cpu"
    assert cfg["model"] == "mlp" and cfg["analytic_guidance"] is True
    # the JAX tool's own config keys, from its main with the pipeline
    # stubbed out
    import spinnerf_tpu.pipeline.stages as jstages
    monkeypatch.setattr(jstages, "run_pipeline", _stub_results)
    jout = tmp_path / "jax.json"
    _jax_tool().main(SMOKE + ["--workdir", str(tmp_path / "jw"),
                              "--out", str(jout)])
    jres = json.loads(jout.read_text())
    assert list(cfg) == list(jres["config"])
    for k in ("model", "views", "n_gt", "analytic_guidance", "train_res",
              "iters"):
        assert cfg[k] == jres["config"][k], k


def test_resume_marker(tmp_path, monkeypatch):
    made = []
    make_scene = tsynthetic.make_scene

    def counted(*a, **kw):
        made.append(kw["n_views"])
        return make_scene(*a, **kw)
    monkeypatch.setattr(tsynthetic, "make_scene", counted)
    monkeypatch.setattr(tstages, "run_pipeline", _stub_results)
    work = tmp_path / "w"
    args = ["--views", "4", "--gt", "1", "--h", "32", "--w", "40",
            "--workdir", str(work)]
    for argv in (args, args, args[:1] + ["5"] + args[2:], args):
        assert full_run.main(argv, device="cpu") == 0
    assert made == [4, 5, 4]
    marker = json.loads((work / "scene" / "fullrun_scene.json").read_text())
    assert marker == {"views": 4, "gt": 1, "h": 32, "w": 40, "factor": 2,
                      "analytic": True}
    fdir = work / "scene" / "images_2"
    assert not (fdir / "lama_images").exists()
    assert len(list((work / "scene" / "analytic_guidance" / "depth")
                    .glob("*.png"))) == 4
    # an unfinished scene (no points3D.bin) is generated again
    (work / "scene" / "sparse" / "0" / "points3D.bin").unlink()
    assert full_run.main(args, device="cpu") == 0
    assert made == [4, 5, 4, 4]
    res = json.loads((work / "FULLRUN_torch.json").read_text())
    assert "per_view" not in res and res["config"]["views"] == 4


def test_gt_must_be_positive(tmp_path):
    with pytest.raises(SystemExit, match="--gt must be >= 1"):
        full_run.main(["--gt", "0", "--workdir", str(tmp_path)],
                      device="cpu")
