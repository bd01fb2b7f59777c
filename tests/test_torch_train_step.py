"""One and two steps of the port's `make_train_step` against the JAX
package's, from the same scene arrays, sparse-depth list and converted
parameters, with perturb off (both steps are then deterministic), f32, and
no mesh on the JAX side; over the hash-grid field and over the fused MLP
field (the JAX side runs its Pallas kernels in interpret mode). Loss terms
within 1e-5 relative, gradients within 1e-4 relative (max-normalized per
parameter), parameters after Adam within 1e-6 absolute."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spinnerf_tpu.core.rendering import RenderConfig as JRenderConfig
from spinnerf_tpu.data import colmap, llff, synthetic
from spinnerf_tpu.data import raybank as jraybank
from spinnerf_tpu.models.hashgrid import HashGridField as JField
from spinnerf_tpu.ops.fused_mlp import FusedMLPField as JMLPField
from spinnerf_tpu.train import loop as jloop
from spinnerf_tpu.train import schedule as jschedule
from spinnerf_tpu.train import step as jstep
from spinnerf_tpu_torch.convert import fields_state_dicts
from spinnerf_tpu_torch.core.rendering import RenderConfig as TRenderConfig
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import raybank as traybank
from spinnerf_tpu_torch.models.hashgrid import HashGridField as TField
from spinnerf_tpu_torch.ops.fused_mlp import FusedMLPField as TMLPField
from spinnerf_tpu_torch.train import loop as tloop
from spinnerf_tpu_torch.train import schedule as tschedule
from spinnerf_tpu_torch.train import step as tstep

torch.set_num_threads(1)

SMALL = dict(bound=4.0, n_levels=6, log2_table_size=13, base_res=4,
             finest_res_per_unit=64.0, hidden_dim=16, hidden_dim_color=16)
# 2 octaves, not 10: the two pipelines compute the sample points in
# different f32 orders (rays, ray_points, sample_pdf: ~1e-7 relative), and
# the encoding's top octave multiplies that difference by 2^(multires-1).
# At 10 octaves (x512) the loss terms differ by up to 1e-2 relative, at 4
# (x8) by 3e-5. `tests/test_torch_fused_mlp.py` holds the 10-octave
# encoding on identical points.
SMALL_MLP = dict(depth=6, width=32, multires=2, multires_views=2)
# lrate_decay 0.001 -> transition over 1 step: lr(1) = lr(0) / 10, so an
# off-by-one in the schedule's step index shows as a 10x update (9e-5 here).
# Adam's first update is lr * g / (|g| + eps): for table entries whose
# gradient nearly cancels to |g| ~ eps, f32 summation order alone moves it
# by up to ~0.5% of lr, so lr = 1e-4 keeps the 1e-6 bound meaningful.
LRATE, DECAY = 1e-4, 0.001


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"),
                             n_views=5, h=32, w=40, factor=1)
    sc = llff.load_scene(d, factor=1)
    dl = colmap.sparse_depth_for_views(d / "sparse" / "0", factor=1,
                                       bd_scale=sc.scale)
    return sc, dl


def _grad_capture():
    """A pass-through transformation whose state holds the gradients."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return grads, grads
    return optax.GradientTransformation(init, update)


# Each case: TrainConfig options, with "field" (the MLP field instead of
# the hash grid), "opt" (make_optimizer's grad_clip / table_wd) and "atol"
# (the parameters' bound after Adam) taken out first. The semantic case
# builds the MVSeg bank and fields with the semantic head.
CASES = {
    "prepare": dict(prepare=True),
    "masked_depth_sigma": dict(depth_supervision=True, weighted_loss=True,
                               sigma_loss=True),
    "mlp_prepare": dict(prepare=True, field="mlp"),
    "mlp_masked_depth_sigma": dict(depth_supervision=True,
                                   weighted_loss=True, sigma_loss=True,
                                   field="mlp"),
    # --no_coarse with table decay: the coarse table gets no gradient from
    # the loss, and JAX still decays it (optax adds wd * p to its zero
    # gradient), moving each entry by ~lr a step
    "no_coarse_table_wd": dict(prepare=True, use_coarse_loss=False,
                               opt=dict(table_wd=1e-2)),
    "grad_clip": dict(prepare=True, opt=dict(grad_clip=1e-3)),
    "semantic": dict(semantic=True),
    "object_removal": dict(object_removal=True),
    "masked_nerf": dict(masked_nerf=True),
    "no_geometry": dict(no_geometry=True),
    "depth_with_rgb": dict(depth_supervision=True, depth_with_rgb=True),
    # Adam's first step on table entries whose gradient nearly cancels (see
    # LRATE): the relative, normalized depth loss and the distortion term
    # put fine.encoder.table 1.0e-6 and 1.5e-6 from JAX, so 2e-6
    "relative_normalized_depth": dict(depth_supervision=True,
                                      relative_loss=True,
                                      normalize_depth=True, atol=2e-6),
    "distortion": dict(prepare=True, distortion_weight=0.01, atol=2e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(scene, case):
    kw = dict(CASES[case])
    mlp = kw.pop("field", None) == "mlp"
    opt_kw = kw.pop("opt", {})
    atol = kw.pop("atol", 1e-6)
    jsc, dl = scene
    bank_kw = dict(prepare=kw.get("prepare", False),
                   semantic=kw.get("semantic", False))
    jbank = jraybank.build_raybank(jsc, np.arange(5), depth_list=dl,
                                   **bank_kw)
    tsc = tllff.Scene(**{f.name: getattr(jsc, f.name)
                         for f in dataclasses.fields(llff.Scene)})
    tbank = traybank.build_raybank(tsc, np.arange(5), depth_list=dl,
                                   device="cpu", **bank_kw)

    if mlp:
        jmodel = JMLPField(**SMALL_MLP, compute_dtype=jnp.float32, block=512)

        def make_field():
            return TMLPField(**SMALL_MLP, compute_dtype=torch.float32,
                             device="cpu")
    else:
        # the hash calibration the trainers pin: identical from both banks
        field_kw = dict(SMALL, semantic=bank_kw["semantic"])
        jmodel = JField(**field_kw, impl="win_xla", compute_dtype=jnp.float32)
        bounds, boxes = jloop._scene_hash_calibration(jbank, jmodel)
        probe = TField(**field_kw, compute_dtype=torch.float32,
                       device="meta")
        assert tloop._scene_hash_calibration(tbank, probe) == (bounds, boxes)
        jmodel = jmodel.clone(page_bounds=bounds, dense_box=boxes)

        def make_field():
            return TField(**field_kw, compute_dtype=torch.float32,
                          page_bounds=bounds, dense_box=boxes, device="cpu")

    rcfg = dict(n_samples=12, n_importance=6, perturb=False,
                semantic=bank_kw["semantic"])
    jcfg = jstep.TrainConfig(render=JRenderConfig(**rcfg), n_rand=64, **kw)
    tcfg = tstep.TrainConfig(render=TRenderConfig(**rcfg), n_rand=64, **kw)
    groups = jstep._active_groups(jcfg, jbank)
    assert tstep._active_groups(tcfg, tbank) == groups
    assert ("inp" in groups) == (
        not (bank_kw["prepare"] or kw.get("semantic")
             or kw.get("object_removal") or kw.get("no_geometry")))

    params = jstep.init_params(jmodel, jax.random.PRNGKey(1), n_importance=6)
    rng = np.random.RandomState(2)
    for k in params:
        if not mlp:
            # a trained-looking table so the encode carries signal
            tab = params[k]["params"]["encoder"]["table"]
            params[k]["params"]["encoder"]["table"] = jnp.asarray(
                rng.randn(*tab.shape).astype(np.float32) * 0.3)

    tx = optax.chain(_grad_capture(),
                     jschedule.make_optimizer(LRATE, DECAY, **opt_kw))
    jfn = jstep.make_train_step(jmodel, jcfg, jbank, tx)
    opt_state = tx.init(params)

    fields = torch.nn.ModuleDict({k: make_field()
                                  for k in ("coarse", "fine")})
    opt = tschedule.make_optimizer(fields.named_parameters(), LRATE, DECAY,
                                   **opt_kw)
    tfn = tstep.make_train_step(fields, tcfg, tbank, opt)

    def rel(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    # The second update replays step 1's batch: its sample points are the
    # ones already compared, so a coordinate one ulp from a cell face (rays
    # of another batch are computed in another summation order) cannot send
    # a point's gradient to other table entries. The optimizer's count, not
    # the batch index, selects the learning rate, so the second update still
    # checks lr(1) and Adam's moments.
    for step_idx in (1, 1):
        # start each step from JAX's parameters: after one update the two
        # differ by f32 noise, which can flip a ReLU near its kink
        with torch.no_grad():
            for k, sd in fields_state_dicts(
                    jax.tree.map(np.asarray, params)).items():
                for name, p in fields[k].named_parameters():
                    p.copy_(sd[name])
        params, opt_state, jm = jfn(jax.tree.map(jnp.copy, params),
                                    opt_state, jax.random.PRNGKey(0),
                                    step_idx)
        jgrads = fields_state_dicts(jax.tree.map(np.asarray, opt_state[0]))
        opt.zero_grad()
        loss, tm = tfn.loss_fn(step_idx)
        loss.backward()
        assert set(tm) == set(jm)
        for name in jm:
            assert rel(tm[name].detach().numpy(), np.asarray(jm[name])) < 1e-5, \
                name
        for k in fields:
            for name, p in fields[k].named_parameters():
                # no loss reaches the coarse field without the coarse loss:
                # its gradient stays None here and is zero in JAX
                g = torch.zeros_like(p) if p.grad is None else p.grad
                assert rel(g.numpy(), jgrads[k][name].numpy()) < 1e-4, \
                    (step_idx, k, name)
        opt.step()
        jparams = fields_state_dicts(jax.tree.map(np.asarray, params))
        for k in fields:
            for name, p in fields[k].named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), jparams[k][name].numpy(), rtol=0,
                    atol=atol, err_msg=f"step {step_idx} {k}.{name}")
    assert opt.count == 2
    # each case reaches the terms it names
    want = {"semantic": {"clf_loss"}, "object_removal": {"acc_loss"},
            "distortion_weight": {"distortion"},
            "depth_supervision": {"depth_loss"}, "sigma_loss": {"sigma_loss"}}
    for opt_name, terms in want.items():
        if kw.get(opt_name):
            assert terms <= set(jm), (opt_name, set(jm))
    if kw.get("masked_nerf"):
        assert "masked_loss" not in jm
    assert ("inp_loss" in jm) == ("inp" in groups)


@pytest.mark.parametrize("count", [1, 1000, 70000])
def test_epoch_indices_match_jax(count):
    """Including steps where the JAX int32 arithmetic wraps."""
    for step in (0, 1, 17, 5000, 3_000_000):
        np.testing.assert_array_equal(
            traybank.epoch_indices(step, 64, count).numpy(),
            np.asarray(jraybank.epoch_indices(step, 64, count)))


def test_sampled_batches_match_jax(scene):
    jsc, dl = scene
    tsc = tllff.Scene(**{f.name: getattr(jsc, f.name)
                         for f in dataclasses.fields(llff.Scene)})
    jbank = jraybank.build_raybank(jsc, np.arange(5), depth_list=dl)
    tbank = traybank.build_raybank(tsc, np.arange(5), depth_list=dl,
                                   device="cpu")
    for step in (0, 3, 40):
        for name in ("rgb", "clf", "inp"):
            jb, jt = jraybank.sample_group(None, jbank, name, 64, step=step)
            tb, tt = traybank.sample_group(tbank, name, 64, step=step)
            for k in jb:
                np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                           rtol=0, atol=1e-6)
            for k in jt:
                np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
        jd = jraybank.sample_depth_group(None, jbank, 64, step=step)
        td = traybank.sample_depth_group(tbank, 64, step=step)
        for k in jd:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=0, atol=1e-6)


def test_schedule_reads_count_before_update():
    sched = tschedule.exponential_lr(LRATE, 250)
    ref = jschedule.exponential_lr(LRATE, 250)
    for count in (0, 1, 7, 1000, 250000):
        np.testing.assert_allclose(sched(count), float(ref(count)), rtol=1e-6)
    assert tschedule.exponential_lr(LRATE, 0)(10 ** 6) == LRATE
