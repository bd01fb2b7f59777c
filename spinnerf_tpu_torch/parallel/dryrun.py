"""The data-parallel paths at one rank and at N (the port's counterpart of
the JAX package's `__graft_entry__.py::dryrun_multichip`).

`dryrun_data_parallel(n, device)` runs, in this process without a process
group and on n launched ranks (`parallel.launch`):

1. the fused NeRF step on the hash-grid field at the production table
   (16 x 2^19 x 2, the scene-calibrated index, f32) in prepare mode with
   COLMAP sparse depth and stratified jitter, one step;
2. the LaMa adversarial step (G + D + EMA, synced BatchNorm), and the same
   step under two controls that break it (`CONTROLS`);
3. a frame rendered pixel-sharded with the fields after step 1;

and raises AssertionError when N ranks do not compute what one rank
computes: the loss within 1e-5 relative and the parameters within 1e-5
absolute (step 1, JAX's gates); G's parameters within 5e-3 (step 2, JAX's
gate, which one Adam step cannot exceed: it moves a parameter by at most
lr = 1e-3), and the tighter gates of step 2 (`LAMA_*`: the metrics, the
BatchNorm running statistics and the averaged gradients before the clip),
each of which a control must fail (`CONTROL_FAILS`); the frame within
1e-6 of its largest value (step 3; equal on the CPU); the replicas'
parameters bit-equal on every path. Returns the worst differences and each rank's launches of the
hash kernels #1 / #2.

The rank functions (`nerf_steps`, `lama_steps`, `frame_render`,
`fit_config`, `fail_one_rank`) take plain data and run under `launch` or,
without a group, in this process; the CPU tests call them too, so that no
spawned process imports a test module.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from spinnerf_tpu_torch.parallel import mesh as mesh_lib


class DryrunSize(NamedTuple):
    views: int          # synthetic scene: views, height, width
    h: int
    w: int
    n_rand: int         # rays a group, samples a pass (coarse = fine)
    samples: int
    ngf: int            # LaMa G width and FFC blocks, batch, crop side
    n_blocks: int
    lama_batch: int
    crop: int
    perceptual: bool    # the resnet_pl term (ADE20k ResNet50, seeded)
    chunk: int          # frame render chunk


# the chip check: big-lama's width and the prepare step's batch
FULL = DryrunSize(views=6, h=252, w=336, n_rand=1024, samples=64, ngf=64,
                  n_blocks=18, lama_batch=8, crop=256, perceptual=True,
                  chunk=32768)
# the CPU check: the same table, small batches and networks
SMALL = DryrunSize(views=4, h=24, w=32, n_rand=64, samples=16, ngf=8,
                   n_blocks=1, lama_batch=4, crop=32, perceptual=False,
                   chunk=256)

NERF_LOSS_REL = 1e-5
NERF_PARAM_ABS = 1e-5
LAMA_GEN_ABS = 5e-3
RENDER_REL = 1e-6
# the LaMa step's own gates, each between the sound runs' largest reading and
# a control's (big-lama on an H100; the readings in PERF.md §6): the
# metrics of the step's starting state (relative), the BatchNorm running
# statistics of G and D (of max(1, |value|)) and the averaged gradients of
# G and D before the clip (relative L2)
LAMA_METRIC_REL = 1e-5
LAMA_STATS_REL = 1e-5
LAMA_GRAD_REL = 1e-2
# the metrics of D's phase, whose fake images G makes after its update, so
# that they carry its Adam step's rounding (one rank and N differ by up to
# 2 lr in a parameter whose gradient is near 0): reported, not gated; D's
# phase is held by its gradients and statistics
AFTER_G_UPDATE = ("d_adv", "d_total")
# controls: G's and D's BatchNorms on each rank's own shard, and the
# gradients summed across the ranks instead of averaged
CONTROLS = ("unsynced_bn", "grad_sum")


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (bit-equality across
    processes)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _rank_info():
    mesh = mesh_lib.current()
    return mesh, (0 if mesh is None else mesh.rank), \
        (1 if mesh is None else mesh.size)


def _make_fields(field, device, state=None, seed=0):
    """{"coarse", "fine"} fields: field = ("hash" | "mlp", kwargs), from
    `state` ({name: {param: tensor}}) or seeded."""
    from spinnerf_tpu_torch.models.hashgrid import HashGridField
    from spinnerf_tpu_torch.ops.fused_mlp import FusedMLPField
    kind, kw = field
    cls = HashGridField if kind == "hash" else FusedMLPField
    kw = dict(kw)
    kw["compute_dtype"] = getattr(torch, kw.get("compute_dtype", "float32"))
    gen = torch.Generator().manual_seed(seed)
    fields = nn.ModuleDict()
    for name in ("coarse", "fine"):
        fields[name] = cls(device=device, **kw)
        fields[name].reset_parameters(gen)
    if state is not None:
        _load_fields(fields, state)
    return fields


def _load_fields(fields, state):
    with torch.no_grad():
        for k, sd in state.items():
            for name, p in fields[k].named_parameters():
                p.copy_(torch.as_tensor(sd[name]))


def _fields_state(fields):
    return {k: {n: p.detach().cpu().clone()
                for n, p in fields[k].named_parameters()} for k in fields}


def nerf_steps(spec: dict, *, device):
    """Train steps of `train.step.make_train_step` on this rank (under the
    process group, if any). spec: "scene" (`llff.Scene` fields), "depth_list",
    "bank" (`build_raybank` options), "field", "state" (or "seed"),
    "render" / "train" (`RenderConfig` / `TrainConfig` options), "opt"
    (`make_optimizer` options), "steps" (step indices), optional "reload"
    (a state to load before each step), "gen_seed", "record" (keep the
    averaged gradients and the parameters after every step), "lpips"
    (`make_patch_lpips_fn` options: the patch term from step 1, on a
    seeded random VGG16 unless its weights are dropped in).

    Returns {"rank", "size", "metrics" (a dict of floats a step), "digest"
    (the final parameters), "launches" (#1 / #2 in the steps),
    "all_reduces" (the collectives in the steps)} and, on rank
    0, "params" (final) and with "record" "grads" / "params_per_step"."""
    return _nerf_run(spec, device)[0]


def _nerf_run(spec, device):
    """`nerf_steps`' result, and the fields it trained."""
    from spinnerf_tpu_torch.core.rendering import RenderConfig
    from spinnerf_tpu_torch.data import llff, raybank
    from spinnerf_tpu_torch.ops import hash_encode_win as hw
    from spinnerf_tpu_torch.train import schedule
    from spinnerf_tpu_torch.train import step as step_lib

    mesh, rank, size = _rank_info()
    device = torch.device(device)
    scene = llff.Scene(**spec["scene"])
    bank = raybank.build_raybank(scene, np.arange(len(scene.images)),
                                 depth_list=spec.get("depth_list"),
                                 device=device, **spec["bank"])
    fields = _make_fields(spec["field"], device, spec.get("state"),
                          spec.get("seed", 0))
    opt = schedule.make_optimizer(fields.named_parameters(), **spec["opt"])
    tcfg = step_lib.TrainConfig(render=RenderConfig(**spec["render"]),
                                **spec["train"])
    record = spec.get("record", False) and rank == 0
    grads, per_step = [], []
    if record:
        apply = opt.step

        def recording_step():   # the gradients the update is made from
            grads.append({k: {n: None if p.grad is None
                              else p.grad.detach().cpu().clone()
                              for n, p in fields[k].named_parameters()}
                          for k in fields})
            apply()
        opt.step = recording_step
    lpips_fn = None
    if spec.get("lpips") is not None:
        from spinnerf_tpu_torch.models.lpips import load_lpips
        from spinnerf_tpu_torch.train.lpips_patch import make_patch_lpips_fn
        lpips_fn = make_patch_lpips_fn(
            fields, scene, np.arange(len(scene.images)),
            lpips=load_lpips(device=device), render=tcfg.render,
            near=bank.near, far=bank.far, ndc=bank.ndc, start_iter=0,
            **spec["lpips"])
    step_fn = step_lib.make_train_step(fields, tcfg, bank, opt, mesh=mesh,
                                       lpips_fn=lpips_fn)
    gen = torch.Generator(device).manual_seed(spec.get("gen_seed", 0))
    metrics = []
    before, reduces = dict(hw.launches), mesh_lib.calls["all_reduce"]
    for j, i in enumerate(spec["steps"]):
        if spec.get("reload"):
            _load_fields(fields, spec["reload"][j])
        m = step_fn(i, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        if record:
            per_step.append(_fields_state(fields))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"rank": rank, "size": size, "metrics": metrics,
           "digest": digest(fields.parameters()),
           "launches": {k: hw.launches[k] - before[k] for k in before},
           "all_reduces": mesh_lib.calls["all_reduce"] - reduces}
    if rank == 0:
        out["params"] = _fields_state(fields)
        if record:
            out.update(grads=grads, params_per_step=per_step)
    return out, fields


class _SummingMesh(mesh_lib.Mesh):
    """A control's mesh: the gradients summed across ranks, not averaged."""
    __slots__ = ()

    def all_reduce_mean_(self, tensors):
        super().all_reduce_mean_(tensors)
        for t in tensors:
            t.mul_(self.size)


def lama_steps(spec: dict, *, device):
    """LaMa train steps (`train.lama_trainer.make_lama_train_step`) on this
    rank: spec "gen" / "disc" (network options), "state" (a
    `LamaTrainState.state_dict()`, or "seed"), "perceptual" (None or
    `make_resnet_pl` options), "images" [k, B, H, W, 3] and "masks"
    [k, B, H, W, 1] (numpy, the global batches), optional "control" (one of
    `CONTROLS`) and "record" (keep the first step's gradients of G and D as
    the clip receives them). Returns {"rank", "size", "metrics", "digest"}
    and, on rank 0, the final "state" (G, D, EMA) and with "record"
    "grads" ({"gen", "disc"}: one flat tensor each)."""
    from spinnerf_tpu_torch.models.batchnorm import sync_batchnorm
    from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator
    from spinnerf_tpu_torch.models.lama import FFCResNetGenerator
    from spinnerf_tpu_torch.models.segmentation import make_resnet_pl
    from spinnerf_tpu_torch.train import lama_trainer as lt

    mesh, rank, size = _rank_info()
    control = spec.get("control")
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    if control == "grad_sum":
        mesh = _SummingMesh(*mesh)
    gen = FFCResNetGenerator(device=device, **spec["gen"])
    disc = NLayerDiscriminator(device=device, **spec["disc"])
    perceptual = None
    if spec.get("perceptual") is not None:
        perceptual, _ = make_resnet_pl(device=device, **spec["perceptual"])
    init_fn, step_fn = lt.make_lama_train_step(gen, disc,
                                               perceptual_fn=perceptual,
                                               mesh=mesh)
    if control == "unsynced_bn":
        sync_batchnorm(gen, None)
        sync_batchnorm(disc, None)
    state = init_fn(spec.get("seed", 0))
    if spec.get("state") is not None:
        # a copy: the optimizers keep the tensors they load and update them
        state.load_state_dict(copy.deepcopy(spec["state"]))
    grads = {}
    clip = lt.clip_by_global_norm_
    first_g = next(gen.parameters())

    def recording_clip(params, max_norm):   # the gradients, averaged
        net = "gen" if params[0] is first_g else "disc"
        grads.setdefault(net, torch.cat([p.grad.detach().reshape(-1)
                                         for p in params]).cpu())
        return clip(params, max_norm)

    if spec.get("record", False) and rank == 0:
        lt.clip_by_global_norm_ = recording_clip
    metrics = []
    try:
        for imgs, masks in zip(spec["images"], spec["masks"]):
            m = step_fn(state, lt.to_nchw(imgs, device),
                        lt.to_nchw(masks, device))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        lt.clip_by_global_norm_ = clip
    sd = {"gen": gen.state_dict(), "disc": disc.state_dict(),
          "ema": dict(state.ema)}
    out = {"rank": rank, "size": size, "metrics": metrics,
           "digest": digest([t for part in sd.values()
                             for t in part.values()])}
    if rank == 0:
        out["state"] = {k: {n: t.detach().cpu().clone() for n, t in v.items()}
                        for k, v in sd.items()}
        if grads:
            out["grads"] = grads
    return out


def frame_render(spec: dict, *, device):
    """One frame through `eval.render.make_param_frame_renderer`, pixel-
    sharded under the process group: spec "field", "state" (or "seed"),
    "hwf", "c2w", "render" (`RenderConfig` options), "near", "far",
    "chunk". Returns {"rank", "size", "maps" (numpy), "digest"}."""
    fields = _make_fields(spec["field"], device, spec.get("state"),
                          spec.get("seed", 0))
    return _render(spec, fields, device)


def _render(spec, fields, device):
    from spinnerf_tpu_torch.core.rendering import RenderConfig
    from spinnerf_tpu_torch.eval import render as eval_render

    mesh, rank, size = _rank_info()
    renderer = eval_render.make_param_frame_renderer(
        spec["hwf"], fields, RenderConfig(**spec["render"]),
        near=spec["near"], far=spec["far"], chunk=spec["chunk"],
        device=device, mesh=mesh)
    maps = renderer(spec["c2w"])
    return {"rank": rank, "size": size, "maps": maps,
            "digest": digest(torch.from_numpy(np.ascontiguousarray(v))
                             for v in maps.values())}


def dryrun_rank(nerf_spec: dict, lama_spec: dict, render_spec: dict, *,
                device):
    """The dry run's paths on this rank, in one process: the NeRF steps
    (`nerf_steps`), the LaMa steps (`lama_steps`), then under each of
    `CONTROLS`, and the frame (`frame_render`) with the fields the NeRF
    steps trained."""
    nerf, fields = _nerf_run(nerf_spec, device)
    return {"nerf": nerf, "lama": lama_steps(lama_spec, device=device),
            "controls": {c: lama_steps(dict(lama_spec, control=c),
                                       device=device) for c in CONTROLS},
            "render": _render(render_spec, fields, device)}


def fit_config(cfg_kwargs: dict, n_iters: int, *, device):
    """`Trainer(Config(**cfg_kwargs))` on this rank, one `fit` call a step
    to `n_iters`. Returns {"rank", "size" (the trainer's mesh), "psnr" (a
    float a step), "digest"}."""
    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.train.loop import Trainer

    tr = Trainer(Config(**cfg_kwargs), device=device, log=lambda *a: None)
    psnr = [float(tr.fit(i)["psnr"]) for i in range(tr.step + 1,
                                                     n_iters + 1)]
    return {"rank": 0 if tr.mesh is None else tr.mesh.rank,
            "size": 1 if tr.mesh is None else tr.mesh.size, "psnr": psnr,
            "digest": digest(tr.fields.parameters())}


def fail_one_rank(*, device):
    """Rank 1 raises while the others wait for it in a collective: the
    launch must fail, not hang."""
    mesh = mesh_lib.current()
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()


# --- the dry run ------------------------------------------------------------


def _nerf_spec(tmp, size: DryrunSize):
    from spinnerf_tpu_torch.data import colmap, llff, raybank, synthetic
    from spinnerf_tpu_torch.models.hashgrid import HashGridField
    from spinnerf_tpu_torch.train.loop import _scene_hash_calibration

    d = synthetic.make_scene(tmp, n_views=size.views, h=size.h, w=size.w,
                             factor=1)
    scene = llff.load_scene(d, factor=1)
    depth_list = colmap.sparse_depth_for_views(d / "sparse" / "0", factor=1,
                                               bd_scale=scene.scale)
    bank = raybank.build_raybank(scene, np.arange(size.views),
                                 depth_list=depth_list, prepare=True,
                                 device="cpu")
    probe = HashGridField(compute_dtype=torch.float32, device="meta")
    _check(probe.log2_table_size == 19 and probe.n_levels == 16,
           "the production table", (probe.n_levels, probe.log2_table_size))
    bounds, boxes = _scene_hash_calibration(bank, probe)
    return dict(
        scene=dataclasses.asdict(scene), depth_list=depth_list,
        bank=dict(prepare=True),
        field=("hash", dict(compute_dtype="float32", page_bounds=bounds,
                            dense_box=boxes)),
        seed=0, gen_seed=1, steps=[1],
        render=dict(n_samples=size.samples, n_importance=size.samples,
                    perturb=True),
        train=dict(n_rand=size.n_rand, prepare=True, depth_supervision=True),
        opt=dict(lrate=5e-4, lrate_decay=250)), scene


def _lama_spec(size: DryrunSize):
    from spinnerf_tpu_torch.data.lama_masks import MixedMaskGenerator
    from spinnerf_tpu_torch.train.lama_trainer import make_batch
    rng = np.random.RandomState(3)
    photos = [rng.rand(size.crop + 16, size.crop + 24, 3).astype(np.float32)
              for _ in range(size.lama_batch)]
    crops, masks = make_batch(photos, MixedMaskGenerator(), rng,
                              crop=size.crop)
    return dict(gen=dict(ngf=size.ngf, n_blocks=size.n_blocks),
                disc=dict(ndf=size.ngf, n_layers=2 if size.ngf < 64 else 4),
                perceptual=dict(depth=50) if size.perceptual else None,
                seed=2, images=crops[None], masks=masks[None], record=True)


def _max_abs(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def lama_readings(ref: dict, got: dict) -> dict:
    """`lama_steps` results with "record" on N ranks (`got`, rank 0's) against
    one rank (`ref`): each reading that a `LAMA_*` gate holds."""
    m1, mn = ref["metrics"][0], got["metrics"][0]
    stats = 0.0
    for net in ("gen", "disc"):
        for name, v in ref["state"][net].items():
            if "running" in name:
                w = got["state"][net][name].double()
                stats = max(stats, float(((w - v.double()).abs()
                                          / v.double().abs().clamp(min=1.0))
                                         .max()))
    return dict(
        gen_max_abs=_max_abs(ref["state"]["gen"], got["state"]["gen"]),
        metrics_max_rel=max(_rel(mn[k], v) for k, v in m1.items()
                            if k not in AFTER_G_UPDATE),
        after_g_max_rel=max(_rel(mn[k], m1[k]) for k in AFTER_G_UPDATE),
        stats_max_rel=stats,
        grad_rel_l2={net: float((got["grads"][net].double() - g.double())
                                .norm() / g.double().norm())
                     for net, g in ref["grads"].items()})


def lama_gates(r: dict) -> dict:
    """Which `LAMA_*` gate each reading of `lama_readings` passes."""
    return dict(
        gen=r["gen_max_abs"] <= LAMA_GEN_ABS,
        metrics=r["metrics_max_rel"] <= LAMA_METRIC_REL,
        stats=r["stats_max_rel"] <= LAMA_STATS_REL,
        grads=max(r["grad_rel_l2"].values()) <= LAMA_GRAD_REL)


# the gates each control must fail: unsynced statistics change G's output,
# so its metrics, and the running statistics; a sum is the mean times N,
# which Adam's update and the clip do not see
CONTROL_FAILS = {"unsynced_bn": ("metrics", "stats"),
                 "grad_sum": ("grads",)}


def _check(ok: bool, what: str, reading):
    if not ok:
        raise AssertionError(f"{what}: {reading}")


def dryrun_data_parallel(n: int, device=None, *, size: DryrunSize = FULL,
                         log=print) -> dict:
    """The three paths at one rank (this process, on `device`, else
    `cuda:0`) and at n ranks (one `launch(n, dryrun_rank, ...,
    device=device)`), the LaMa step also under each of `CONTROLS`; see the
    module docstring. The one-rank frame renders with the n ranks' fields,
    so that both render the same parameters. Returns {"nerf", "lama",
    "controls", "render", "seconds"}."""
    ref_device = device if device is not None else "cuda:0"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spinnerf_dryrun_") as tmp:
        spec, scene = _nerf_spec(tmp, size)
    lspec = _lama_spec(size)
    rspec = dict(field=spec["field"], hwf=tuple(scene.hwf),
                 c2w=scene.poses[0],
                 render=dict(n_samples=size.samples,
                             n_importance=size.samples, perturb=False),
                 near=scene.near, far=scene.far, chunk=size.chunk)
    ref = nerf_steps(spec, device=ref_device)
    lref = lama_steps(lspec, device=ref_device)
    t1 = time.perf_counter()
    ranks = mesh_lib.launch(n, dryrun_rank, spec, lspec, rspec,
                            device=device)
    t2 = time.perf_counter()
    nerf0, lama0, frame0 = (ranks[0][k] for k in ("nerf", "lama", "render"))
    fref = frame_render(dict(rspec, state=nerf0["params"]),
                        device=ref_device)
    out = {}

    def same(path):
        return len({r[path]["digest"] for r in ranks}) == 1

    loss1, lossn = ref["metrics"][0]["loss"], nerf0["metrics"][0]["loss"]
    out["nerf"] = dict(
        loss=lossn, loss_rel=abs(lossn - loss1) / max(abs(loss1), 1.0),
        param_max_abs=max(_max_abs(ref["params"][k], nerf0["params"][k])
                          for k in ref["params"]),
        replicas_equal=same("nerf"),
        launches=[r["nerf"]["launches"] for r in ranks],
        ref_launches=ref["launches"])
    log(f"[dryrun] NeRF step 1 rank vs {n}: {out['nerf']}")
    out["lama"] = dict(lama_readings(lref, lama0),
                       g_total=lama0["metrics"][0]["g_total"],
                       replicas_equal=same("lama"))
    log(f"[dryrun] LaMa step 1 rank vs {n}: {out['lama']}")
    out["controls"] = {}
    for c in CONTROLS:
        got = ranks[0]["controls"][c]
        reading = dict(lama_readings(lref, got),
                       replicas_equal=len({r["controls"][c]["digest"]
                                           for r in ranks}) == 1)
        reading["fails"] = sorted(k for k, ok in lama_gates(reading).items()
                                  if not ok)
        out["controls"][c] = reading
        log(f"[dryrun] LaMa step under control {c}: {reading}")
    diff = max(float(np.abs(frame0["maps"][k] - v).max())
               for k, v in fref["maps"].items())
    scale = max(float(np.abs(v).max()) for v in fref["maps"].values())
    out["render"] = dict(
        shape=fref["maps"]["rgb"].shape, max_abs=diff, max_value=scale,
        equal=all(np.array_equal(frame0["maps"][k], v)
                  for k, v in fref["maps"].items()),
        replicas_equal=same("render"))
    log(f"[dryrun] frame 1 rank vs {n}: {out['render']}")
    out["seconds"] = dict(one_rank=t1 - t0, ranks=t2 - t1,
                          total=time.perf_counter() - t0)

    _check(bool(np.isfinite(lossn)), "the NeRF loss", lossn)
    _check(out["nerf"]["loss_rel"] <= NERF_LOSS_REL, "the NeRF loss, 1 rank "
           f"vs {n}", out["nerf"])
    _check(out["nerf"]["param_max_abs"] <= NERF_PARAM_ABS, "the NeRF "
           f"parameters, 1 rank vs {n}", out["nerf"])
    _check(all(np.isfinite(v) for v in lama0["metrics"][0].values()),
           "the LaMa metrics", lama0["metrics"][0])
    for gate, ok in lama_gates(out["lama"]).items():
        _check(ok, f"the LaMa step's {gate} gate, 1 rank vs {n}",
               out["lama"])
    for c, reading in out["controls"].items():
        _check(set(CONTROL_FAILS[c]) <= set(reading["fails"]),
               f"control {c} passes a gate it must fail "
               f"({CONTROL_FAILS[c]})", reading)
    _check(all(np.isfinite(v).all() for v in frame0["maps"].values()),
           "the frame", "not finite")
    _check(diff <= RENDER_REL * scale, f"the frame, 1 rank vs {n}",
           out["render"])
    for path in ("nerf", "lama", "render"):
        _check(out[path]["replicas_equal"], f"the {path} replicas",
               out[path])
    return out
