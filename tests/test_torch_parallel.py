"""Data parallelism (`spinnerf_tpu_torch/parallel/`) on the CPU: N gloo ranks
spawned by `parallel.launch` against one rank of the port and against the
JAX package's mesh steps on the virtual CPU devices.

- the fused step at N = 2 and 4 (hash grid) and 2 (the fused MLP field),
  two updates each from JAX's parameters before it, as
  `test_torch_train_step.py` holds one device: loss terms within 1e-5
  relative, gradients within 1e-4 (max-normalised), parameters after Adam
  within 1e-6 at lr 1e-4, against JAX's step on a 2-device mesh and the
  port's one rank;
- the inpainted-disparity NaN guard zeroes the whole term when only one
  rank's shard holds the NaN, as the global mean of JAX and one rank
  does;
- three free steps with stratified jitter, density noise and uniform
  sampling from the step's generator: the replicas bit-equal, the metrics
  and parameters within the bounds above of one rank's; a group of one
  rank bit-equal to no group;
- the patch-LPIPS term, whole on every rank, against one rank;
- the LaMa step (ngf 8) against one rank, JAX's mesh step and the port's
  float64 step: synced BatchNorm statistics and running buffers;
- `lama_train --mesh_shape 2` writes once, on rank 0, and logs one
  rank's losses;
- the pixel-sharded frame bit-equal to the unsharded one, at 2, 3 and 4
  ranks;
- `dryrun_data_parallel` at 2 ranks (the production table): every gate
  passed, and each control failing the gates it must fail;
- a failing rank fails the launch; N_rand not divisible by N, and
  `Trainer(mesh_shape=2)` outside a group, raise ValueError.

The rank functions live in `parallel/dryrun.py`: no spawned process imports
this module (or JAX)."""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spinnerf_tpu.core.rendering import RenderConfig as JRenderConfig
from spinnerf_tpu.data import colmap, llff, synthetic
from spinnerf_tpu.data import raybank as jraybank
from spinnerf_tpu.models.discriminator import NLayerDiscriminator as JD
from spinnerf_tpu.models.hashgrid import HashGridField as JField
from spinnerf_tpu.models.lama import FFCResNetGenerator as JG
from spinnerf_tpu.ops.fused_mlp import FusedMLPField as JMLPField
from spinnerf_tpu.parallel import mesh as jmesh
from spinnerf_tpu.train import lama_trainer as jlt
from spinnerf_tpu.train import loop as jloop
from spinnerf_tpu.train import schedule as jschedule
from spinnerf_tpu.train import step as jstep
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.core.rendering import RenderConfig as TRenderConfig
from spinnerf_tpu_torch.data import raybank as traybank
from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator as TD
from spinnerf_tpu_torch.models.hashgrid import HashGridField as TField
from spinnerf_tpu_torch.models.lama import FFCResNetGenerator as TG
from spinnerf_tpu_torch.parallel import dryrun
from spinnerf_tpu_torch.parallel import mesh as mesh_lib
from spinnerf_tpu_torch.train import lama_trainer as tlt
from spinnerf_tpu_torch.train import loop as tloop
from spinnerf_tpu_torch.train import schedule as tschedule
from spinnerf_tpu_torch.train import step as tstep
from spinnerf_tpu_torch.train.loop import Trainer
from test_torch_lama_train import _hold_step, _jax_dicts, _np
from test_torch_train_step import DECAY, LRATE, SMALL, SMALL_MLP

torch.set_num_threads(1)

RENDER = dict(n_samples=12, n_importance=6, perturb=False)
TRAIN = dict(n_rand=64, depth_supervision=True, weighted_loss=True,
             sigma_loss=True)
GK = dict(ngf=8, n_blocks=1, max_features=32)
DK = dict(ndf=8, n_layers=2)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"),
                             n_views=5, h=32, w=40, factor=1)
    sc = llff.load_scene(d, factor=1)
    dl = colmap.sparse_depth_for_views(d / "sparse" / "0", factor=1,
                                       bd_scale=sc.scale)
    return sc, dl


def _grad_capture():
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return grads, grads
    return optax.GradientTransformation(init, update)


def _scene_dict(sc):
    return {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}


def _port_spec(sc, dl, field, train=TRAIN, state=None, steps=(1, 1)):
    """`dryrun.nerf_steps`' spec: the port's calibration of the hash index
    (equal to JAX's, `test_torch_train_step.py`), seeded fields unless
    `state` is given."""
    if field == "mlp":
        tfield = ("mlp", dict(SMALL_MLP))
    else:
        tbank = traybank.build_raybank(sc, np.arange(5), depth_list=dl,
                                       device="cpu")
        bounds, boxes = tloop._scene_hash_calibration(
            tbank, TField(**SMALL, device="meta"))
        tfield = ("hash", dict(SMALL, page_bounds=bounds, dense_box=boxes))
    return dict(scene=_scene_dict(sc), depth_list=dl, bank={},
                field=tfield, state=state, steps=list(steps), render=RENDER,
                train=train, opt=dict(lrate=LRATE, lrate_decay=DECAY))


def _jax_run(sc, dl, field, steps=(1, 1)):
    """JAX's step on a 2-device mesh, `steps` updates. Returns the port's
    spec for the same parameters, each step reloading JAX's parameters
    before it, and JAX's metrics, gradients and parameters after each step
    as the port's state dicts."""
    jbank = jraybank.build_raybank(sc, np.arange(5), depth_list=dl)
    if field == "mlp":
        jmodel = JMLPField(**SMALL_MLP, compute_dtype=jnp.float32, block=512)
    else:
        jmodel = JField(**SMALL, impl="win_xla", compute_dtype=jnp.float32)
        bounds, boxes = jloop._scene_hash_calibration(jbank, jmodel)
        jmodel = jmodel.clone(page_bounds=bounds, dense_box=boxes)
    params = jstep.init_params(jmodel, jax.random.PRNGKey(1), n_importance=6)
    if field != "mlp":
        rng = np.random.RandomState(2)
        for k in params:
            tab = params[k]["params"]["encoder"]["table"]
            params[k]["params"]["encoder"]["table"] = jnp.asarray(
                rng.randn(*tab.shape).astype(np.float32) * 0.3)
    tx = optax.chain(_grad_capture(),
                     jschedule.make_optimizer(LRATE, DECAY))
    jfn = jstep.make_train_step(
        jmodel, jstep.TrainConfig(render=JRenderConfig(**RENDER), **TRAIN),
        jbank, tx, mesh=jmesh.make_mesh(jax.devices()[:2]))
    opt_state = tx.init(params)

    def sd(tree):
        return convert.fields_state_dicts(jax.tree.map(np.asarray, tree))

    reload, out = [], {"metrics": [], "grads": [], "params": []}
    for i in steps:
        reload.append(sd(params))
        params, opt_state, m = jfn(jax.tree.map(jnp.copy, params),
                                   opt_state, jax.random.PRNGKey(0), i)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append(sd(opt_state[0]))
        out["params"].append(sd(params))
    spec = _port_spec(sc, dl, field, state=reload[0], steps=steps)
    spec.update(reload=reload, record=True)
    return spec, out


@pytest.fixture(scope="module")
def jax_runs(scene):
    return {f: _jax_run(*scene, f) for f in ("hash", "mlp")}


def _hold_steps(got, want, atol=1e-6):
    """Each step's loss terms, averaged gradients and parameters after the
    update (`nerf_steps`' record) against `want`'s."""
    for k, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(gm) == set(wm)
        for name in wm:
            assert rel(gm[name], wm[name]) < 1e-5, (k, name)
        for f, params in got["params_per_step"][k].items():
            for name, p in params.items():
                g = got["grads"][k][f][name]
                g = torch.zeros_like(p) if g is None else g
                assert rel(g.numpy(), want["grads"][k][f][name].numpy()) \
                    < 1e-4, (k, f, name)
                np.testing.assert_allclose(
                    p.numpy(), want["params"][k][f][name].numpy(), rtol=0,
                    atol=atol, err_msg=f"step {k} {f}.{name}")


@pytest.mark.parametrize("field,n", [("hash", 2), ("hash", 4), ("mlp", 2)])
def test_steps_match_one_rank_and_jax_mesh(jax_runs, field, n):
    spec, jax_out = jax_runs[field]
    one = dryrun.nerf_steps(spec, device="cpu")
    ranks = mesh_lib.launch(n, dryrun.nerf_steps, spec, device="cpu")
    assert [r["rank"] for r in ranks] == list(range(n))
    assert {r["size"] for r in ranks} == {n} and one["size"] == 1
    assert "inp_loss" in one["metrics"][0]      # every group is sharded
    assert len({r["digest"] for r in ranks}) == 1
    want_one = dict(metrics=one["metrics"], grads=one["grads"],
                    params=one["params_per_step"])
    _hold_steps(ranks[0], jax_out)
    _hold_steps(ranks[0], want_one)
    _hold_steps(one, jax_out)


def test_nan_on_one_rank_zeroes_the_term_everywhere(scene):
    """A NaN in the inpainted disparity under one pixel of rank 1's share
    of step 1's inp batch: the global mean is NaN and the term is 0, as in
    JAX and the port's one rank (held to JAX's guard by
    `test_steps_match_one_rank_and_jax_mesh`); rank 0's own share has no
    NaN, and its term must be 0 as well."""
    sc, dl = scene
    tsc = dataclasses.replace(sc, inpainted_depths=sc.inpainted_depths.copy())
    bank = traybank.build_raybank(tsc, np.arange(5), depth_list=dl,
                                  device="cpu")
    g = bank.groups["inp"]
    pos = traybank.epoch_indices(1, 64, g.count)
    v, r, c = g.idx[pos[40]].tolist()          # rank 1 holds rows 32-63
    tsc.inpainted_depths[v, r, c] = np.nan
    spec = _port_spec(tsc, dl, "hash", steps=(1,))
    one = dryrun.nerf_steps(spec, device="cpu")["metrics"][0]
    ranks = mesh_lib.launch(2, dryrun.nerf_steps, spec, device="cpu")
    tm = ranks[0]["metrics"][0]
    assert one["inp_loss"] == 0.0 and tm["inp_loss"] == 0.0
    assert np.isfinite(one["loss"])
    for name in one:
        assert rel(tm[name], one[name]) < 1e-5, name
    # without the NaN, the term is not 0
    clean = dryrun.nerf_steps(_port_spec(sc, dl, "hash", steps=(1,)),
                              device="cpu")["metrics"][0]
    assert clean["inp_loss"] > 0.0


def test_free_steps_with_draws_replicas_equal(scene):
    """Three steps with jitter, density noise and uniform batches, all drawn
    from the step's generator for the whole batch: the replicas end
    bit-equal, and within the step bounds of one rank (1e-5 after three
    Adam steps at lr 1e-4)."""
    spec = _port_spec(*scene, "hash", steps=(1, 2, 3))
    spec.update(gen_seed=5, render=dict(RENDER, perturb=True,
                                        raw_noise_std=1.0),
                train=dict(TRAIN, epoch_sampling=False))
    one = dryrun.nerf_steps(spec, device="cpu")
    ranks = mesh_lib.launch(2, dryrun.nerf_steps, spec, device="cpu")
    assert len({r["digest"] for r in ranks}) == 1
    for gm, wm in zip(ranks[0]["metrics"], one["metrics"]):
        for name in wm:
            assert rel(gm[name], wm[name]) < 1e-5, name
    for f, params in one["params"].items():
        for name, p in params.items():
            np.testing.assert_allclose(ranks[0]["params"][f][name].numpy(),
                                       p.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{f}.{name}")


@pytest.mark.parametrize("field", ["hash", "mlp"])
def test_group_of_one_is_bit_equal_to_no_group(scene, field):
    """A process group of one rank (every collective run, each an identity)
    against no group, three free steps with draws: the metrics and the
    parameters bit-equal. On the card the kernels' float atomics (#2, #10)
    make two runs differ, so this holds there only to the runs' spread."""
    spec = _port_spec(*scene, field, steps=(1, 2, 3))
    spec.update(gen_seed=5, render=dict(RENDER, perturb=True),
                train=dict(TRAIN, epoch_sampling=False))
    one = dryrun.nerf_steps(spec, device="cpu")
    (group,) = mesh_lib.launch(1, dryrun.nerf_steps, spec, device="cpu")
    assert group["size"] == 1 and one["size"] == 1
    assert group["all_reduces"] >= 3 and one["all_reduces"] == 0
    assert group["metrics"] == one["metrics"]
    assert group["digest"] == one["digest"]


def test_patch_lpips_term_matches_one_rank(scene):
    """The fit's patch-LPIPS term (4 patches of 16 x 20, from step 1),
    computed whole on each of 2 ranks, against one rank: every metric
    within 1e-5 relative and the parameters within 1e-6 after 2 updates
    at lr 1e-4."""
    spec = _port_spec(*scene, "hash", steps=(1, 2))
    spec.update(lpips=dict(lpips_render_factor=1, patch_len_factor=2,
                           batch_size=4),
                train=dict(TRAIN, depth_supervision=False))
    one = dryrun.nerf_steps(spec, device="cpu")
    ranks = mesh_lib.launch(2, dryrun.nerf_steps, spec, device="cpu")
    assert len({r["digest"] for r in ranks}) == 1
    for gm, wm in zip(ranks[0]["metrics"], one["metrics"]):
        assert wm["lpips_loss"] > 0
        for name in wm:
            assert rel(gm[name], wm[name]) < 1e-5, name
    for f, params in one["params"].items():
        for name, p in params.items():
            np.testing.assert_allclose(ranks[0]["params"][f][name].numpy(),
                                       p.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{f}.{name}")


@pytest.fixture(scope="module")
def lama_runs():
    """One LaMa step from JAX's initial state: JAX's on a 2-device mesh,
    and the port's at 1 and 2 ranks (f32) and at 1 (float64)."""
    rng = np.random.RandomState(4)
    imgs = rng.rand(1, 4, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(1, 4, 32, 32, 1) > 0.6).astype(np.float32)
    init, jfn = jlt.make_lama_train_step(
        JG(**GK), JD(**DK), mesh=jmesh.make_mesh(jax.devices()[:2]))
    jstate = init(jax.random.PRNGKey(0), image_shape=(4, 32, 32, 3))
    j0 = jax.tree.map(np.asarray, jstate)
    jstate, jm = jfn(jstate, jnp.asarray(imgs[0]), jnp.asarray(masks[0]),
                     jax.random.PRNGKey(0))

    def port_state(dtype):
        tg, td = TG(device="cpu", **GK), TD(device="cpu", **DK)
        tg.to(dtype)
        td.to(dtype)
        tinit, tstep = tlt.make_lama_train_step(tg, td)
        state = convert.lama_train_state(j0, tinit(0))
        for opt in (state.gen_opt, state.disc_opt):
            for p, s in opt.state.items():
                for k in ("exp_avg", "exp_avg_sq"):
                    s[k] = s[k].to(p.dtype)
        return state, tstep

    spec = dict(gen=GK, disc=DK, state=port_state(torch.float32)[0]
                .state_dict(), images=imgs, masks=masks)
    state64, step64 = port_state(torch.float64)
    step64(state64, tlt.to_nchw(imgs[0], "cpu").double(),
           tlt.to_nchw(masks[0], "cpu").double())
    return dict(
        jax=_jax_dicts(jax.tree.map(np.asarray, jstate)),
        jax_metrics={k: float(v) for k, v in jm.items()},
        one=dryrun.lama_steps(spec, device="cpu"),
        ranks=mesh_lib.launch(2, dryrun.lama_steps, spec, device="cpu"),
        f64={"gen": _np(state64.gen.state_dict()),
             "disc": _np(state64.disc.state_dict())})


def test_lama_step_matches_jax_mesh_and_one_rank(lama_runs):
    """Two ranks against JAX's 2-device mesh step with the one-step rule of
    `test_torch_lama_train.py` (BN running statistics within 1e-6; each
    parameter within 1e-6 where JAX's Adam moment is >= 1e-5, 2 lr
    elsewhere; the EMA within 4 spacings), and within JAX's own 5e-3 of
    the port's one rank."""
    ranks, one = lama_runs["ranks"], lama_runs["one"]
    assert len({r["digest"] for r in ranks}) == 1
    got = {k: _np(v) for k, v in ranks[0]["state"].items()}
    _hold_step(got, lama_runs["jax"])
    for tree in ("gen", "disc", "ema"):
        for name, v in one["state"][tree].items():
            assert np.abs(got[tree][name] - v.double().numpy()).max() \
                <= dryrun.LAMA_GEN_ABS, (tree, name)
    for name, v in lama_runs["jax_metrics"].items():
        assert rel(ranks[0]["metrics"][0][name], v) < 1e-5, name
        assert rel(ranks[0]["metrics"][0][name],
                   one["metrics"][0][name]) < 1e-5, name


def test_lama_synced_batchnorm_statistics_hold_float64(lama_runs):
    """The running statistics of G and D after the synced step: within
    1e-6 of the port's float64 step on the whole batch (each rank saw
    half of it), as are one rank's."""
    got = {k: _np(v) for k, v in lama_runs["ranks"][0]["state"].items()}
    one = {k: _np(v) for k, v in lama_runs["one"]["state"].items()}
    n_stats = 0
    for tree in ("gen", "disc"):
        for name, want in lama_runs["f64"][tree].items():
            if "running" not in name:
                continue
            n_stats += 1
            assert np.abs(got[tree][name] - want).max() <= 1e-6, name
            assert np.abs(one[tree][name] - want).max() <= 1e-6, name
    assert n_stats >= 10


def test_lama_train_command_on_two_ranks(tmp_path, capfd):
    """`lama_train --mesh_shape 2` on the CPU: rank 0 alone writes the
    metrics, the grid and the checkpoint; the losses it logs against the
    same command on one rank (the same global batches from the seed):
    step 0's within 1e-6 relative, step 2's totals within 1e-4 and each
    term within JAX's LaMa gate, 5e-3."""
    from spinnerf_tpu_torch.cli.__main__ import main
    from spinnerf_tpu_torch.eval.render import write_png
    rng = np.random.RandomState(5)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        write_png(src / f"im{i}.png",
                  (rng.rand(40, 48, 3) * 255).astype(np.uint8))
    argv = ["lama_train", "--indir", str(src), "--n_steps", "3",
            "--batch_size", "2", "--crop", "32", "--ngf", "8",
            "--n_blocks", "1"]
    rows = {}
    for n in (1, 2):
        exp = tmp_path / f"r{n}"
        assert main(argv + ["--exp_dir", str(exp), "--mesh_shape", str(n)],
                    device="cpu") == 0
        assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == \
            ["ckpt_00000002.pt"]
        assert sorted(p.name for p in (exp / "visualizations").iterdir()) \
            == ["step_000000.png"]
        rows[n] = [json.loads(line) for line in
                   (exp / "metrics.jsonl").read_text().splitlines()]
    assert capfd.readouterr().out.count("training images from") == 2
    assert [r["step"] for r in rows[2]] == [r["step"] for r in rows[1]] \
        == [0, 2]
    for r1, r2 in zip(rows[1], rows[2]):
        for name, v in r1.items():
            # the step-0 losses come from the same state; later ones carry
            # step 1's Adam noise, which the small R1 term feels most
            # (measured 1.07e-3 relative; the others within 2.3e-5)
            bound = (1e-6 if r1["step"] == 0
                     else 1e-4 if name.endswith("total") else 5e-3)
            assert rel(r2[name], v) < bound, (r1["step"], name)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_pixel_sharded_frame_is_bit_equal(n):
    """768 pixels in chunks of 100 (rounded up to a multiple of n: 100 or
    102, the last chunk padded): every map equal to the unsharded
    render's."""
    spec = dict(field=("hash", dict(SMALL)), seed=3, hwf=(24, 32, 20.0),
                c2w=synthetic.look_at_pose(np.array([3.0, 1.0, 1.5]))[:3, :4],
                render=dict(n_samples=8, n_importance=8, perturb=False),
                near=1.0, far=7.0, chunk=100)
    one = dryrun.frame_render(spec, device="cpu")
    ranks = mesh_lib.launch(n, dryrun.frame_render, spec, device="cpu")
    assert len({r["digest"] for r in ranks} | {one["digest"]}) == 1
    for name, v in one["maps"].items():
        np.testing.assert_array_equal(ranks[0]["maps"][name], v)
    assert one["maps"]["rgb"].shape == (24, 32, 3)


def test_dryrun_data_parallel_two_ranks():
    out = dryrun.dryrun_data_parallel(2, device="cpu", size=dryrun.SMALL,
                                      log=lambda *a: None)
    assert out["nerf"]["replicas_equal"] and out["render"]["equal"]
    assert out["nerf"]["loss_rel"] <= dryrun.NERF_LOSS_REL
    assert all(dryrun.lama_gates(out["lama"]).values()), out["lama"]
    assert out["lama"]["replicas_equal"]
    for c, gates in dryrun.CONTROL_FAILS.items():
        assert set(gates) <= set(out["controls"][c]["fails"]), (c, out)
    # summed gradients are the averaged ones times the two ranks
    assert abs(out["controls"]["grad_sum"]["grad_rel_l2"]["gen"] - 1.0) \
        < 1e-3


def test_a_failing_rank_fails_the_launch():
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 fails on purpose"):
        mesh_lib.launch(2, dryrun.fail_one_rank, device="cpu")
    assert time.perf_counter() - t0 < 60


def test_n_rand_must_split_over_the_ranks(scene):
    sc, dl = scene
    bank = traybank.build_raybank(sc, np.arange(5), depth_list=dl,
                                  device="cpu")
    fields = dryrun._make_fields(("hash", dict(SMALL)), "cpu")
    opt = tschedule.make_optimizer(fields.named_parameters(), LRATE, DECAY)
    mesh = mesh_lib.Mesh(0, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="N_rand 64 does not split over 3"):
        tstep.make_train_step(fields, tstep.TrainConfig(
            render=TRenderConfig(**RENDER), n_rand=64), bank, opt, mesh=mesh)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        traybank.sample_group(bank, "rgb", 64, step=1, mesh=mesh)


def test_trainer_mesh_shape_needs_a_process_group(tmp_path):
    assert mesh_lib.current() is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        Trainer(Config(expname="m", basedir=str(tmp_path), mesh_shape=2),
                device="cpu")
