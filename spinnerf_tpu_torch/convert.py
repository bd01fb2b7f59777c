"""Carry the JAX package's parameters across to the port.

`fields_state_dicts` takes the JAX parameter tree as numpy arrays — what
`jax.tree.map(np.asarray, params)` gives for `init_params`' {"coarse",
"fine"} — and returns one state dict per field: `HashGridField` and
`NeRFField` from flax trees, `FusedMLPField` from the fused weight dict.
flax Dense kernels are [in, out]; `nn.Linear.weight` is [out, in].
`lpips_state_dict` does the same for the LPIPS VGG16 and its heads, and
`lama_state_dict` for the LaMa generator (flax Conv kernels are [kh, kw,
in, out]; torch's [out, in, kh, kw]). The LaMa-training networks follow:
`discriminator_state_dict`, `segmentation_state_dict`,
`inception_state_dict`, `flax_state_dict` / `ffc_discriminator_state_dict`
for the pix2pixHD zoo, and `lama_train_state`, which loads a whole JAX
`LamaTrainState` (G, D, EMA, both Adam states, the step) into the port's.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_fused(tree) -> bool:
    return "feat_w" in tree


def fused_weights(jax_dict) -> dict:
    """The JAX fused weight dict (`FusedMLPField.init`'s, numpy leaves) ->
    `FusedMLPField.weights` tensors (the same names, shapes and values)."""
    return {n: torch.from_numpy(np.array(v, np.float32))
            for n, v in jax_dict.items()}


def field_state_dict(tree) -> dict:
    """One field's parameters -> its state dict: a flax tree ({"params":
    {...}} or the inner dict) for `HashGridField`/`NeRFField`, or a fused
    weight dict for `FusedMLPField`."""
    if _is_fused(tree):
        return {f"weights.{n}": v for n, v in fused_weights(tree).items()}
    tree = tree.get("params", tree)
    out = {}
    for name, leaf in tree.items():
        if name == "encoder":
            out["encoder.table"] = torch.from_numpy(
                np.array(leaf["table"], np.float32))
        else:
            out[f"{name}.weight"] = torch.from_numpy(
                np.array(leaf["kernel"], np.float32).T.copy())
            out[f"{name}.bias"] = torch.from_numpy(
                np.array(leaf["bias"], np.float32))
    return out


def fields_state_dicts(params) -> dict:
    """{"coarse": tree, "fine": tree} -> {"coarse": state dict, "fine": ...}."""
    return {k: field_state_dict(v) for k, v in params.items()}


def nerf_field_tree(model) -> dict:
    """A port `NeRFField`'s parameters as the flax tree of numpy arrays
    (the inverse of `field_state_dict` for its layers)."""
    return {"params": {
        name: {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
               "bias": lin.bias.detach().cpu().numpy().copy()}
        for name, lin in model.named_children()}}


def lpips_state_dict(vgg_params, lin) -> dict:
    """The JAX LPIPS parameters (`load_lpips(...).consts`: the flax VGG16
    tree and the five heads; numpy or JAX leaves) -> the state dict of
    `models.lpips.LPIPS`. flax Conv kernels are [kh, kw, in, out]; torch's
    are [out, in, kh, kw]."""
    tree = vgg_params.get("params", vgg_params)
    out = {}
    for name, leaf in tree.items():
        out[f"vgg.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.array(leaf["kernel"], np.float32), (3, 2, 0, 1))))
        out[f"vgg.{name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32))
    for i, w in enumerate(lin):
        out[f"lin{i}"] = torch.from_numpy(np.array(w, np.float32))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.array(a, np.float32)))


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def lama_conv_state(sd, dst, p):
    """A flax Conv ({"kernel" [kh, kw, in, out], "bias"?}) into `sd` as
    torch's `dst.weight` [out, in, kh, kw] (and `dst.bias`)."""
    sd[_key(dst, "weight")] = _t(np.transpose(np.asarray(p["kernel"]),
                                              (3, 2, 0, 1)))
    if "bias" in p:
        sd[_key(dst, "bias")] = _t(p["bias"])


def lama_conv_transpose_state(sd, dst, p):
    """The JAX package's `TorchConvTranspose` ({"kernel", "bias"}; the
    kernel spatially flipped, [kh, kw, in, out]) into `sd` as a
    ConvTranspose2d's `dst.weight` [in, out, kh, kw] and `dst.bias`."""
    sd[_key(dst, "weight")] = _t(np.transpose(
        np.asarray(p["kernel"]), (2, 3, 0, 1))[:, :, ::-1, ::-1])
    sd[_key(dst, "bias")] = _t(p["bias"])


def lama_bn_state(sd, dst, p, s):
    """A flax BatchNorm's params and batch stats into `sd` (`dst.weight`,
    `.bias`, `.running_mean`, `.running_var`)."""
    for name, v in (("weight", p["scale"]), ("bias", p["bias"]),
                    ("running_mean", s["mean"]), ("running_var", s["var"])):
        sd[_key(dst, name)] = _t(v)


def lama_spectral_state(sd, dst, p, s):
    """A `SpectralTransform`'s variables into `sd` under `dst`."""
    lama_conv_state(sd, _key(dst, "conv1.0"), p["conv1"])
    lama_bn_state(sd, _key(dst, "conv1.1"), p["conv1_bn"], s["conv1_bn"])
    for name in ("fu", "lfu"):
        if name in p:
            lama_conv_state(sd, _key(dst, f"{name}.conv_layer"),
                            p[name]["conv"])
            lama_bn_state(sd, _key(dst, f"{name}.bn"), p[name]["bn"],
                          s[name]["bn"])
    lama_conv_state(sd, _key(dst, "conv2"), p["conv2"])


def lama_ffc_state(sd, dst, p, s):
    """An `FFC`'s variables into `sd` under `dst`."""
    for name in ("convl2l", "convl2g", "convg2l"):
        if name in p:
            lama_conv_state(sd, _key(dst, name), p[name])
    if "convg2g" in p:
        lama_spectral_state(sd, _key(dst, "convg2g"), p["convg2g"],
                            s["convg2g"])


def lama_ffc_bn_act_state(sd, dst, p, s):
    """An `FFCBnAct`'s variables (its FFC and the branches' BNs) into `sd`
    under `dst`."""
    lama_ffc_state(sd, _key(dst, "ffc"), p["ffc"], s.get("ffc", {}))
    for name in ("bn_l", "bn_g"):
        if name in p:
            lama_bn_state(sd, _key(dst, name), p[name], s[name])


def lama_state_dict(variables) -> dict:
    """The JAX LaMa generator's variables ({"params", "batch_stats"}, numpy
    or JAX leaves, any number of blocks) -> the big-lama `state_dict` of
    `models.lama.FFCResNetGenerator` (`model.{i}...` keys): the inverse of
    the JAX package's `convert_big_lama`; the `lama_*_state` helpers convert
    one module each."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}

    def ffc_bn_act(dst, p, s):
        lama_ffc_bn_act_state(sd, dst, p, s)

    n_down = sum(k.startswith("down") for k in params)
    n_blocks = sum(k.startswith("block") for k in params)
    ffc_bn_act("model.1", params["stem"], stats["stem"])
    for i in range(n_down):
        ffc_bn_act(f"model.{2 + i}", params[f"down{i}"], stats[f"down{i}"])
    for b in range(n_blocks):
        for half in ("conv1", "conv2"):
            ffc_bn_act(f"model.{2 + n_down + b}.{half}",
                       params[f"block{b}"][half], stats[f"block{b}"][half])
    idx = 3 + n_down + n_blocks            # after the concat layer
    for i in range(n_down):
        lama_conv_transpose_state(sd, f"model.{idx}", params[f"up{i}"])
        lama_bn_state(sd, f"model.{idx + 1}", params[f"up{i}_bn"],
                      stats[f"up{i}_bn"])
        idx += 3
    lama_conv_state(sd, f"model.{idx + 1}", params["head"])  # after the pad
    return sd


def flax_state_dict(variables, *, transpose=lambda name: False) -> dict:
    """Any flax tree of Conv ("kernel"[, "bias"]) and BatchNorm ("scale",
    "bias"; "mean", "var" in batch_stats) leaves -> a state dict under the
    same names joined by "." (the pix2pixHD zoo, `models/generators.py`,
    and `NLayerDiscriminator`). `transpose(name)` marks the JAX package's
    `TorchConvTranspose` modules (ConvTranspose2d in the port)."""
    sd = {}

    def walk(p, s, prefix):
        for k in sorted(p):
            v, dst = p[k], _key(prefix, k)
            if "kernel" in v:
                (lama_conv_transpose_state if transpose(k)
                 else lama_conv_state)(sd, dst, v)
            elif "scale" in v:
                lama_bn_state(sd, dst, v, s[k])
            else:
                walk(v, s.get(k, {}), dst)
    walk(variables["params"], variables.get("batch_stats", {}), "")
    return sd


def discriminator_state_dict(variables) -> dict:
    """The JAX `NLayerDiscriminator`'s variables -> the port's state dict
    (the same module names)."""
    return flax_state_dict(variables)


def ffc_discriminator_state_dict(variables) -> dict:
    """The JAX `FFCNLayerDiscriminator`'s variables -> the port's."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name == "out":
            lama_conv_state(sd, "out", p)
        else:
            lama_ffc_bn_act_state(sd, name, p, stats.get(name, {}))
    return sd


_SEG_RENAME = {"conv_down": "downsample.0", "bn_down": "downsample.1",
               "fuse_conv": "conv_last.0", "fuse_bn": "conv_last.1",
               "out": "conv_last.4"}


def _seg_name(name: str) -> str:
    """A JAX segmentation module name -> the MIT checkpoint's."""
    if name.startswith("layer"):
        return name.replace("_", ".")          # layer3_0 -> layer3.0
    if name.startswith("ppm"):                 # ppm2_conv -> ppm.2.1
        k, kind = name[3:].split("_")
        return f"ppm.{k}.{1 if kind == 'conv' else 2}"
    return _SEG_RENAME.get(name, name)


def segmentation_state_dict(variables) -> dict:
    """The JAX `SegmentationModel`'s variables ({"params": {"encoder",
    "decoder"}, "batch_stats"}) -> the port's state dict, or a bare
    `ResNetDilated`'s (as `make_resnet_pl` builds it) -> the port encoder's:
    MIT checkpoint names (`layer3.0.downsample.0`, `ppm.1.2`,
    `conv_last.4`)."""
    sd = {}

    def walk(p, s, prefix):
        for k in sorted(p):
            v, dst = p[k], _key(prefix, _seg_name(k))
            if "kernel" in v:
                lama_conv_state(sd, dst, v)
            elif "scale" in v:
                lama_bn_state(sd, dst, v, s[k])
            else:
                walk(v, s.get(k, {}), dst)
    walk(variables["params"], variables.get("batch_stats", {}), "")
    return sd


def inception_state_dict(params) -> dict:
    """The JAX package's folded InceptionV3 params ({block: {"kernel"
    [kh, kw, in, out], "bias"}} or {block: {branch: {...}}}) -> the state
    dict of `models.inception.FIDInceptionV3`."""
    sd = {}
    for name, p in params.items():
        for branch, leaf in ([(None, p)] if "kernel" in p else p.items()):
            lama_conv_state(sd, name if branch is None else
                            f"{name}.{branch}", leaf)
    return sd


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def _load_adam(opt, module, to_sd, adam):
    """The Adam moments `adam` (trees as `to_sd` converts) into the torch
    optimizer `opt` over `module`'s parameters."""
    mu, nu = to_sd(adam.mu), to_sd(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    for name, p in module.named_parameters():
        opt.state[p] = {"step": step.clone(),
                        "exp_avg": mu[name].to(p.device),
                        "exp_avg_sq": nu[name].to(p.device)}


def lama_train_state(jax_state, state):
    """Load the JAX package's `LamaTrainState` (numpy or JAX leaves) into
    the port's `train.lama_trainer.LamaTrainState` `state`: G's and D's
    variables, the EMA, both Adam states and the step. Returns `state`."""
    gv, dv = jax_state.gen_vars, jax_state.disc_vars
    gstats = gv.get("batch_stats", {})
    dstats = dv.get("batch_stats", {})
    state.gen.load_state_dict(lama_state_dict(gv), strict=True)
    state.disc.load_state_dict(discriminator_state_dict(dv), strict=True)

    def gen_sd(tree):
        return lama_state_dict({"params": tree, "batch_stats": gstats})

    def disc_sd(tree):
        return discriminator_state_dict({"params": tree,
                                         "batch_stats": dstats})
    ema = gen_sd(jax_state.ema_params)
    with torch.no_grad():
        for name, e in state.ema.items():
            e.copy_(ema[name])
    _load_adam(state.gen_opt, state.gen, gen_sd,
               _adam_state(jax_state.gen_opt))
    _load_adam(state.disc_opt, state.disc, disc_sd,
               _adam_state(jax_state.disc_opt))
    state.step = int(np.asarray(jax_state.step))
    return state
