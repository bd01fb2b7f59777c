"""Training orchestration: config -> scene -> ray bank -> fused step -> loop
(port of `spinnerf_tpu/train/loop.py`: the hash-grid field and, with
`no_tcnn`, the MLP field).

The scene is handed in or loaded from `datadir` (`data/dispatch.py`), with
COLMAP sparse depth under `--colmap_depth`; `--ft_path` loads weights;
`--lpips` adds stage 5's patch-LPIPS term on a scene with masks;
`--alpha_model_path` takes the density from another experiment's frozen
field. Hooks ported, at the JAX cadences: console metrics and the live
control file (`i_print`), checkpoints (`i_weights`), the spiral videos
(`i_video`), the testset dump with its PSNR (`i_testset`), the prepare-mode
disparity dump for LaMa (`i_feat`, forced at the last step of every `fit`)
and, outside prepare mode, the sanity panel (`i_feat` > 10), the MVSeg
panel (`i_img`, with `mvseg`), and the `page_bounds.json` sidecar that
pins the hash index semantics to the experiment. Options not ported yet
(`--mesh_shape`, the blender and DTU loaders) raise NotImplementedError
naming their ROADMAP.md entry.
"""
from __future__ import annotations

import functools
import json
import time
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.data import colmap, dispatch, llff, raybank
from spinnerf_tpu_torch.eval import metrics as eval_metrics
from spinnerf_tpu_torch.eval import render as eval_render
from spinnerf_tpu_torch.models.fields import NeRFField
from spinnerf_tpu_torch.models.hashgrid import (HashGridField,
                                                calibrate_dense_box,
                                                calibrate_page_bounds,
                                                level_resolutions)
from spinnerf_tpu_torch.models.lpips import load_lpips
from spinnerf_tpu_torch.ops.fused_mlp import FusedMLPField
from spinnerf_tpu_torch.train import checkpoints, schedule
from spinnerf_tpu_torch.train.lpips_patch import make_patch_lpips_fn
from spinnerf_tpu_torch.train.step import (TrainConfig, _active_groups,
                                           init_params, make_train_step)
from spinnerf_tpu_torch.utils.live_control import LiveControl
from spinnerf_tpu_torch.utils.visualization import sanity_panel

_QUEUE_A = "ROADMAP.md queue A"


def _unported(what: str, entry: str):
    return NotImplementedError(f"{what} is not ported yet; see {entry}")


def build_model(cfg: Config, semantic: bool = False, device=None,
                page_bounds=None, dense_box=None, fine: bool = False):
    """The (coarse or fine) field of a Config: the hash grid by default (the
    reference's NeRF_TCNN); with `no_tcnn` the MLP, as `FusedMLPField` where
    its kernels apply and `NeRFField` otherwise. fine=True takes
    `netdepth_fine`/`netwidth_fine`; `i_embed -1` keeps the raw xyz/dir
    inputs (0 octaves)."""
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.no_tcnn:
        depth = cfg.netdepth_fine if fine else cfg.netdepth
        width = cfg.netwidth_fine if fine else cfg.netwidth
        multires = 0 if cfg.i_embed == -1 else cfg.multires
        multires_views = 0 if cfg.i_embed == -1 else cfg.multires_views
        # the fused field needs view directions, the encoding and no
        # frozen-sigma (NeRF_RGB) mode
        if (cfg.fused_mlp and cfg.use_viewdirs and not cfg.alpha_model_path
                and cfg.i_embed != -1 and depth != 5):
            return FusedMLPField(depth=depth, width=width, multires=multires,
                                 multires_views=multires_views,
                                 semantic=semantic, compute_dtype=dt,
                                 device=device)
        return NeRFField(depth=depth, width=width, multires=multires,
                         multires_views=multires_views,
                         use_viewdirs=cfg.use_viewdirs, semantic=semantic,
                         compute_dtype=dt, device=device)
    return HashGridField(semantic=semantic,
                         log2_table_size=cfg.log2_hashmap_size,
                         impl=cfg.hash_impl, compute_dtype=dt,
                         page_bounds=page_bounds, dense_box=dense_box,
                         device=device)


def _scene_hash_calibration(bank, model):
    """(Z-CDF segment boundaries, per-level shifted-morton dense boxes) from
    a deterministic stratified pixel/depth grid over the training poses —
    the same numpy computation as the JAX trainer, so both pin the same
    sidecar for a scene."""
    h, w, focal = bank.hwf
    poses = bank.poses.cpu().numpy()
    ys = np.linspace(0.5, h - 0.5, 24)
    xs = np.linspace(0.5, w - 0.5, 24)
    xx, yy = np.meshgrid(xs, ys)
    dirs = np.stack([(xx - w * 0.5) / focal, -(yy - h * 0.5) / focal,
                     -np.ones_like(xx)], -1)                # [24, 24, 3]
    ts = (np.linspace(bank.near, bank.far, 12, endpoint=False)
          + (bank.far - bank.near) / 24.0)
    pts = []
    for p in poses:
        rd = dirs @ p[:3, :3].T
        pts.append((p[:3, 3] + ts[:, None, None, None] * rd[None])
                   .reshape(-1, 3))
    x01 = np.clip((np.concatenate(pts) + model.bound) / (2.0 * model.bound),
                  0.0, 1.0)
    resolutions = level_resolutions(model.n_levels, model.base_res,
                                    model.finest_res_per_unit * model.bound)
    return (calibrate_page_bounds(x01, model.log2_table_size),
            calibrate_dense_box(x01, resolutions, model.log2_table_size))


def _read_page_bounds(path: Path):
    """(page bounds, dense boxes) pinned by a `page_bounds.json` sidecar; a
    sidecar without "dense_box" pins dense_box=None."""
    data = json.loads(path.read_text())
    bounds = data["page_bounds"]
    bounds = None if bounds is None else tuple(int(c) for c in bounds)
    box = data.get("dense_box")
    box = (None if box is None else tuple(
        None if b is None else tuple(int(v) for v in b) for b in box))
    return bounds, box


def render_config(cfg: Config, *, train: bool) -> RenderConfig:
    return RenderConfig(
        n_samples=cfg.N_samples,
        n_importance=cfg.N_importance,
        perturb=bool(cfg.perturb) and train,
        lindisp=cfg.lindisp,
        raw_noise_std=cfg.raw_noise_std if train else 0.0,
        white_bkgd=cfg.white_bkgd,
        semantic=cfg.mvseg,
        only_object=cfg.object_removal and not train,
    )


def train_config(cfg: Config) -> TrainConfig:
    return TrainConfig(
        render=render_config(cfg, train=True),
        n_rand=cfg.N_rand,
        prepare=cfg.prepare,
        masked_nerf=cfg.masked_NeRF,
        object_removal=cfg.object_removal,
        no_geometry=cfg.no_geometry,
        use_coarse_loss=not cfg.no_coarse,
        single_image=cfg.no_batching,
        precrop_iters=cfg.precrop_iters,
        precrop_frac=cfg.precrop_frac,
        epoch_sampling=cfg.epoch_sampling,
        depth_supervision=cfg.colmap_depth and cfg.depth_loss,
        depth_with_rgb=cfg.depth_with_rgb,
        depth_lambda=cfg.depth_lambda,
        weighted_loss=cfg.weighted_loss,
        relative_loss=cfg.relative_loss,
        normalize_depth=cfg.normalize_depth,
        sigma_loss=cfg.sigma_loss,
        sigma_lambda=cfg.sigma_lambda,
        semantic=cfg.mvseg,
        clf_weight=cfg.clf_weight,
        distortion_weight=cfg.distortion_weight,
    )


def _check_ported(cfg: Config):
    if cfg.mesh_shape > 1:
        raise _unported("data parallelism over several cards (--mesh_shape)",
                        _QUEUE_A)


class Trainer:
    """End-to-end DS-NeRF-style trainer on one scene, on one device."""

    def _persist_page_bounds(self, bounds, dense_box):
        """Pin the hash index semantics (Z-CDF page bounds and dense boxes)
        to the experiment: `page_bounds.json` is written on the first run
        and read back, overriding the flag-derived value, on every resume.
        A sidecar without "dense_box" pins dense_box=None."""
        legacy = self.exp_dir / "region_caps.json"
        if legacy.exists() and json.loads(legacy.read_text()).get(
                "region_caps") is not None:
            raise RuntimeError(
                f"{legacy} pins the retired per-region-capacity index "
                f"scheme; this build indexes by Z-CDF page bounds. Retrain "
                f"the experiment (or delete the sidecar if the checkpoints "
                f"are disposable).")
        path = self.exp_dir / "page_bounds.json"
        if path.exists():
            saved, saved_box = _read_page_bounds(path)
            if saved != bounds or saved_box != dense_box:
                self.log(
                    f"page_bounds: using the experiment's pinned value from "
                    f"{path.name} ({'calibrated' if saved else 'uniform'}); "
                    f"the flag-derived value differs and is ignored")
            return saved, saved_box
        path.write_text(json.dumps(
            {"page_bounds": None if bounds is None else list(bounds),
             "dense_box": None if dense_box is None else
             [None if b is None else list(b) for b in dense_box]}))
        return bounds, dense_box

    def __init__(self, cfg: Config, *, scene: llff.Scene | None = None,
                 device=None, log=print):
        _check_ported(cfg)
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        self.exp_dir = cfg.exp_dir()
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        cfg.save()

        # the data (dataset_type dispatch, `run_nerf.py:985-1112`), with the
        # host seconds of the scene and sparse-depth reads in `load_s`
        self.load_s = {}
        t0 = time.perf_counter()
        if scene is not None:
            self.scene = scene
            self.i_train, self.i_test = llff.train_test_split(
                len(scene.images), n_gt=cfg.N_gt, train_gt=cfg.train_gt,
                llffhold=0 if cfg.llffhold >= 1000000 else cfg.llffhold,
                n_train=cfg.N_train,
                train_scene=cfg.train_scene, test_scene=cfg.test_scene)
        else:
            self.scene, self.i_train, self.i_test = \
                dispatch.load_scene_for_config(cfg)
            self.load_s["scene"] = time.perf_counter() - t0
        depth_list = None
        if cfg.colmap_depth:
            t0 = time.perf_counter()
            depth_list = colmap.sparse_depth_for_views(
                Path(cfg.datadir) / "sparse" / "0", factor=cfg.factor,
                bd_scale=self.scene.scale)
            self.load_s["sparse_depth"] = time.perf_counter() - t0
        use_ndc = (cfg.ndc if cfg.dataset_type in ("llff", "nerd")
                   and not cfg.no_ndc else False)
        self.bank = raybank.build_raybank(
            self.scene, self.i_train, depth_list=depth_list,
            prepare=cfg.prepare, train_gt=cfg.train_gt, semantic=cfg.mvseg,
            ndc=use_ndc, device=self.device)

        bounds = dense_box = None
        probe = build_model(cfg, semantic=cfg.mvseg, device="meta")
        if isinstance(probe, HashGridField):
            # the calibration is part of the table's index semantics: the
            # experiment dir pins it (`_persist_page_bounds`)
            if cfg.hash_region_calib:
                bounds, dense_box = _scene_hash_calibration(self.bank, probe)
            bounds, dense_box = self._persist_page_bounds(bounds, dense_box)

        def make_model(fine=False):
            return build_model(cfg, semantic=cfg.mvseg, device=self.device,
                               page_bounds=bounds, dense_box=dense_box,
                               fine=fine)

        self.tcfg = train_config(cfg)
        gen = torch.Generator().manual_seed(cfg.seed)
        # the fine network may be sized separately (`run_nerf.py:417`)
        self.fields = init_params(
            make_model, gen, n_importance=cfg.N_importance,
            make_fine_model=functools.partial(make_model, fine=True))
        self.model = self.fields["coarse"]
        self.optimizer = schedule.make_optimizer(
            self.fields.named_parameters(), cfg.lrate, cfg.lrate_decay,
            cfg.grad_clip, table_wd=cfg.table_wd)
        lpips_fn = None
        if cfg.lpips and self.scene.masks is not None:
            lpips_fn = make_patch_lpips_fn(
                self.fields, self.scene, self.i_train,
                lpips=load_lpips(device=self.device),
                render=render_config(cfg, train=False), near=self.bank.near,
                far=self.bank.far, ndc=self.bank.ndc,
                lpips_render_factor=cfg.lpips_render_factor,
                patch_len_factor=cfg.patch_len_factor,
                batch_size=cfg.lpips_batch_size)
        # NeRF_RGB mode: the density comes, gradient-free, from a frozen
        # pretrained field (`--alpha_model_path`), built like the coarse one
        self.frozen = None
        if cfg.alpha_model_path:
            self.frozen = self._frozen_field()
        self.step_fn = make_train_step(self.fields, self.tcfg, self.bank,
                                       self.optimizer, lpips_fn=lpips_fn,
                                       frozen_raw_fn=self.frozen)
        # draws the stratified jitter and importance uniforms on the device
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.step = 0

        self.ckpt = checkpoints.CheckpointManager(
            self.exp_dir, save_interval=cfg.i_weights)
        step = None
        if cfg.ft_path:
            # explicit weights override the experiment's own checkpoints
            # (`run_nerf.py:1151-1157`)
            step, restored = checkpoints.restore_from_path(
                cfg.ft_path, map_location=self.device)
        elif not cfg.no_reload:
            step, restored = self.ckpt.restore(map_location=self.device)
        if step is not None:
            self.fields.load_state_dict(restored["params"])
            # a parameters-only file keeps the fresh optimizer state
            if restored["opt_state"] is not None:
                self.optimizer.load_state_dict(restored["opt_state"])
            self.step = step
            self.log(f"resumed from checkpoint at step {step}")

    def _frozen_field(self):
        """The `--alpha_model_path` experiment's field (fine, else coarse),
        frozen and built like the coarse one. A hash-grid field reads its
        table under the index it was trained with: that experiment's own
        `page_bounds.json`, which must exist."""
        alpha = Path(self.cfg.alpha_model_path)
        state = checkpoints.frozen_field_state(alpha,
                                               map_location=self.device)
        bounds = dense_box = None
        if isinstance(self.model, HashGridField):
            side = checkpoints.page_bounds_path(alpha)
            if not side.exists():
                raise ValueError(
                    f"--alpha_model_path {alpha}: no page_bounds.json, so "
                    f"the index its hash table was trained under is unknown")
            bounds, dense_box = _read_page_bounds(side)
        field = build_model(self.cfg, semantic=self.cfg.mvseg,
                            device=self.device, page_bounds=bounds,
                            dense_box=dense_box)
        field.load_state_dict(state)
        return field.requires_grad_(False)

    def field_fns(self):
        """(coarse, fine) field callables (pts, viewdirs) -> raw."""
        coarse = self.fields["coarse"]
        return coarse, self.fields["fine"] if "fine" in self.fields else coarse

    def _batches_per_step(self) -> int:
        """Ray batches the fused step renders (the active groups and the
        sparse-depth batch when it is a batch of its own): the rays/s
        denominator."""
        n = len(_active_groups(self.tcfg, self.bank))
        if (self.tcfg.depth_supervision and not self.tcfg.depth_with_rgb
                and self.bank.depth_group is not None
                and self.bank.depth_group.count > 0):
            n += 1
        return n

    # --- rendering helpers ---------------------------------------------------

    def render_poses_list(self, poses, *, render_factor=None, save_dir=None,
                          gt_images=None, save_alpha=False):
        """Render poses with the current fields (`eval_render.render_path`,
        fetching only `maps_for_save`'s maps). Returns (rgbs, disps) numpy."""
        cfg = self.cfg
        rf = cfg.render_factor if render_factor is None else render_factor
        rcfg = render_config(cfg, train=False)
        renderer = eval_render.make_param_frame_renderer(
            self.scene.hwf, self.fields, rcfg, near=self.bank.near,
            far=self.bank.far, ndc=self.bank.ndc, chunk=cfg.chunk,
            render_factor=rf, maps=eval_render.maps_for_save(save_dir,
                                                             save_alpha),
            device=self.device)
        return eval_render.render_path(
            poses, self.scene.hwf, None, rcfg, near=self.bank.near,
            far=self.bank.far, ndc=self.bank.ndc, chunk=cfg.chunk,
            render_factor=rf, save_dir=save_dir, gt_images=gt_images,
            save_alpha=save_alpha, frame_fn=renderer, device=self.device)

    # --- cadence hooks -------------------------------------------------------

    def _video_hook(self, step):
        rgbs, disps = self.render_poses_list(self.scene.render_poses)
        vdir = self.exp_dir / f"video_{step:06d}"
        vdir.mkdir(exist_ok=True)
        eval_render.write_video(vdir / "rgb.mp4", rgbs)
        eval_render.write_video(
            vdir / "disp.mp4", eval_render.normalize_disps_for_video(disps))
        self.log(f"[{step}] wrote spiral videos to {vdir}")

    def _testset_hook(self, step):
        if len(self.i_test) == 0:
            return
        tdir = self.exp_dir / f"testset_{step:06d}"
        rgbs, _ = self.render_poses_list(
            self.scene.poses[self.i_test], save_dir=tdir,
            gt_images=self.scene.images[self.i_test])
        if self.cfg.render_factor:
            # downsampled renders are not compared with full-size images
            # (the reference computes test PSNR only at render_factor 0,
            # `run_nerf.py:1692-1696`)
            self.log(f"[{step}] testset rendered at 1/"
                     f"{self.cfg.render_factor} (no PSNR)")
            return
        ps = [float(eval_metrics.psnr(torch.from_numpy(r),
                                      torch.from_numpy(self.scene.images[t])))
              for r, t in zip(rgbs, self.i_test)]
        self.log(f"[{step}] testset PSNR mean {np.mean(ps):.2f}")
        (tdir / "psnr.json").write_text(json.dumps(
            {"per_view": ps, "mean": float(np.mean(ps))}))

    def _prepare_hook(self, step, out_dir=None):
        """Render every pose's disparity, and its downsampled mask where the
        scene has masks, into the LaMa staging layout
        (`run_nerf.py:1599-1609`): <out>/img{i:03}.png and
        <out>/label/img{i:03}.png, 8-bit grayscale."""
        out = Path(out_dir) if out_dir else self.exp_dir / "lama_input"
        (out / "label").mkdir(parents=True, exist_ok=True)
        _, disps = self.render_poses_list(self.scene.poses)
        rf = max(self.cfg.render_factor, 1)
        for i, d in enumerate(disps):
            eval_render.write_png(
                out / f"img{i:0>3}.png",
                np.clip(np.nan_to_num(d) * 255, 0, 255).astype(np.uint8))
            if self.scene.masks is not None:
                m = np.abs(self.scene.masks[i])[::rf, ::rf]
                eval_render.write_png(
                    out / "label" / f"img{i:0>3}.png",
                    (np.clip(m, 0, 1) * 255).astype(np.uint8))
        self.log(f"[{step}] wrote LaMa guidance inputs to {out}")
        return out

    def _sanity_panel_hook(self, step):
        """The 3-panel render / inpainted-depth prior / disparity image of
        one training view (`run_nerf.py:1581-1597`), written under
        <expdir>/test_renders/."""
        idx = int(np.random.RandomState(step).choice(self.i_train))
        rgbs, disps = self.render_poses_list(self.scene.poses[idx:idx + 1])
        out = self.exp_dir / "test_renders"
        out.mkdir(exist_ok=True)
        prior = (self.scene.inpainted_depths[idx]
                 if self.scene.inpainted_depths is not None
                 else np.zeros(self.scene.images[idx].shape[:2]))
        path = out / f"{self.cfg.expname}_{step:06d}.png"
        sanity_panel(rgbs[0], prior, disps[0], path)
        self.log(f"[{step}] wrote the sanity panel {path}")
        return path

    def _mvseg_panel_hook(self, step):
        """The MVSeg sanity image: one training view's render beside its
        sigmoid objectness map (`MVSeg/DS_NeRF/run_nerf.py:1334-1360`),
        written under <expdir>/test_renders/."""
        idx = int(np.random.RandomState(step).choice(self.i_train))
        renderer = eval_render.make_param_frame_renderer(
            self.scene.hwf, self.fields, render_config(self.cfg, train=False),
            near=self.bank.near, far=self.bank.far, ndc=self.bank.ndc,
            chunk=self.cfg.chunk, render_factor=self.cfg.render_factor,
            maps=("rgb", "prob"), device=self.device)
        maps = renderer(self.scene.poses[idx])
        prob = 1.0 / (1.0 + np.exp(-maps["prob"]))
        panel = np.concatenate([np.clip(maps["rgb"], 0, 1),
                                np.repeat(prob[..., None], 3, -1)], axis=1)
        out = self.exp_dir / "test_renders"
        out.mkdir(exist_ok=True)
        path = out / f"{self.cfg.expname}_seg_{step:06d}.png"
        eval_render.write_png(path, eval_metrics.to8b(panel))
        self.log(f"[{step}] wrote the MVSeg panel {path}")
        return path

    def fit(self, n_iters: int | None = None, *, hooks: bool = True):
        """Train to step `n_iters` (default N_iters), running the cadence
        hooks unless `hooks=False`. Returns the metrics of the last step."""
        cfg = self.cfg
        n_iters = cfg.N_iters if n_iters is None else n_iters
        t0 = time.time()
        rays_done = 0
        metrics = {}
        control = LiveControl(cfg, log=self.log) if hooks else None
        for i in range(self.step + 1, n_iters + 1):
            metrics = self.step_fn(i, self.generator)
            self.step = i
            rays_done += self.tcfg.n_rand * self._batches_per_step()
            if not hooks:
                continue
            if cfg.i_print and i % cfg.i_print == 0:
                control.poll()
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                self.log(f"[{i}/{n_iters}] loss {m['loss']:.4f} "
                         f"psnr {m['psnr']:.2f} "
                         f"({rays_done / max(dt, 1e-9):.0f} rays/s)")
            self.ckpt.maybe_save(i, self.fields.state_dict(),
                                 self.optimizer.state_dict())
            if cfg.i_video and i % cfg.i_video == 0:
                self._video_hook(i)
            if cfg.i_testset and i % cfg.i_testset == 0:
                self._testset_hook(i)
            # prepare mode dumps the LaMa staging every i_feat, as the
            # reference does (`run_nerf.py:1563,1599`; each dump overwrites
            # the last), and at the last step of the call, so that a
            # schedule whose end is not a multiple of i_feat still stages it
            if cfg.prepare and cfg.i_feat and (i % cfg.i_feat == 0
                                               or i == n_iters):
                self._prepare_hook(i)
            elif (not cfg.prepare and cfg.i_feat > 10
                  and i % cfg.i_feat == 0):
                self._sanity_panel_hook(i)
            if cfg.mvseg and cfg.i_img and i % cfg.i_img == 0:
                self._mvseg_panel_hook(i)
        return metrics
