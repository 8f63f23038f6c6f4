"""Checkpoint loading for the port, and the weight carry-over from the JAX
package's parameter trees.

JAX counterpart: ``f5_tts_tpu/utils/ckpt.py`` (``load_torch_state`` :31-64,
``dit_params_from_state`` :102-153, ``dit_params_to_state`` :156-210,
``unett_params_from_state`` :213-273, ``mmdit_params_from_state``
:276-331, the dispatch ``params_from_state`` :334-344,
``vocos_params_from_state`` :351-384, ``bigvgan_params_from_state``
:396-437 with ``_fused_weight`` :385-393; JAX trains into orbax checkpoints,
the port into the reference's ``.pt`` layout, ``save_train_checkpoint``).
The port's modules carry the reference's own parameter names for all three
backbones, so a released state dict loads into them directly:
``load_torch_state`` reads ``.pt`` / ``.safetensors`` files, strips the EMA
prefix, picks the EMA or raw weights and drops bookkeeping keys;
``load_into`` loads by key and raises on any missing one.  BigVGAN's
release file (``bigvgan_generator.pt``) keeps its state dict under a
``"generator"`` key, which ``load_torch_state`` unwraps (JAX's does not, so
the file its hub resolves would not load there); ``load_bigvgan_state``
fuses weight-normed convs (``weight_g`` / ``weight_v``) as JAX does.

``state_from_jax_params`` (dispatching on the config's backbone to the
DiT, UNetT and MMDiT converters) and ``vocos_state_from_jax_params`` turn
the JAX package's canonical (unfused) parameter pytree, as nested dicts of
numpy arrays, into the port's reference-named state dict (pure numpy; the
tests use them to give both implementations the same weights);
``bigvgan_state_from_jax_params`` does the same for BigVGAN.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

_BOOKKEEPING = ("initted", "step", "update")


def load_torch_state(path: str, use_ema: bool = True) -> dict[str, torch.Tensor]:
    """A reference checkpoint file -> {name: tensor on the CPU}.

    ``.safetensors`` releases are EMA-only; ``.pt`` training dicts hold both
    raw and EMA weights and ``use_ema`` picks one.  ``ema_model.`` prefixes
    are stripped; EMA bookkeeping keys and legacy mel / rotary buffers are
    dropped.
    """
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        state = load_file(path, device="cpu")
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "ema_model_state_dict" in obj and use_ema:
            state = obj["ema_model_state_dict"]
        elif isinstance(obj, dict) and "model_state_dict" in obj:
            state = obj["model_state_dict"]
        elif isinstance(obj, dict) and isinstance(obj.get("generator"), dict):
            state = obj["generator"]  # BigVGAN's release (its from_pretrained reads this key)
        else:
            state = obj
    out = {}
    for k, v in state.items():
        if k.startswith("ema_model."):
            k = k[len("ema_model."):]
        if k in _BOOKKEEPING:
            continue
        if k.startswith("mel_spec.") or k.endswith("freqs_cis") or k.endswith("inv_freq"):
            continue
        out[k] = torch.as_tensor(v)
    return out


def load_into(module: nn.Module, state: dict) -> nn.Module:
    """Copy ``state`` into ``module`` by the module's own key names.  Every
    parameter must be present; keys the module does not hold (an ISTFT
    window buffer, an encoder-side feature extractor) are ignored."""
    own = module.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} weights, e.g. {missing[:5]}")
    picked = {}
    for k, ref in own.items():
        v = state[k]
        v = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else torch.as_tensor(v)
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, model {tuple(ref.shape)}")
        picked[k] = v
    module.load_state_dict(picked, strict=True)
    return module


def fuse_weight_norm(state: dict) -> dict:
    """Replace every weight-normed pair ``{name}.weight_g`` / ``.weight_v``
    (torch ``weight_norm``, dim 0) by ``{name}.weight = g v / |v|``, the norm
    over every axis but the first (JAX ``_fused_weight``)."""
    out = {k: v for k, v in state.items() if not k.endswith((".weight_g", ".weight_v"))}
    for k in state:
        if k.endswith(".weight_v"):
            name = k[: -len(".weight_v")]
            v = torch.as_tensor(state[k]).float()
            g = torch.as_tensor(state[f"{name}.weight_g"]).float()
            norm = v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
            out[f"{name}.weight"] = g * v / torch.clamp(norm, min=1e-12)
    return out


def load_bigvgan_state(voc: nn.Module, state: dict) -> nn.Module:
    """Load a BigVGAN generator state dict (reference keys, weight-normed or
    fused) into ``voc``; the release's resample filter buffers are ignored
    (the port builds its own)."""
    return load_into(voc, fuse_weight_norm(state))


def load_dit_state(cfm: nn.Module, state: dict) -> nn.Module:
    """Load a CFM state dict (``transformer.*``) or a bare backbone state
    dict (DiT, UNetT or MMDiT) into ``cfm``."""
    if any(k.startswith("transformer.") for k in state):
        return load_into(cfm, state)
    return load_into(cfm.transformer, state)


def save_train_checkpoint(path: str, model: nn.Module, ema_model: nn.Module, optimizer_state: dict,
                          scheduler_state: dict, step: int, update: int,
                          extra: dict | None = None) -> None:
    """Write a training checkpoint in the reference trainer's ``.pt`` layout,
    which ``load_torch_state`` reads (EMA or raw): ``model_state_dict``,
    ``ema_model_state_dict`` (ema_pytorch's keys: ``ema_model.``-prefixed
    weights plus ``initted`` and ``step``), ``optimizer_state_dict``,
    ``scheduler_state_dict`` and ``step`` (micro-steps taken), plus
    ``extra``'s keys.  Written to a temporary file, then renamed into place."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}  # noqa: E731
    ema = {"initted": torch.tensor(True), "step": torch.tensor(update)}
    ema.update({f"ema_model.{k}": v for k, v in cpu(ema_model.state_dict()).items()})
    obj = {"model_state_dict": cpu(model.state_dict()), "ema_model_state_dict": ema,
           "optimizer_state_dict": optimizer_state, "scheduler_state_dict": scheduler_state,
           "step": step, **(extra or {})}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# weight carry-over from the JAX parameter pytree


class _StateWriter:
    """Reference-named numpy state dict from JAX parameter leaves."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.out: dict[str, np.ndarray] = {}

    def arr(self, name, a):
        self.out[f"{self.prefix}{name}"] = np.ascontiguousarray(np.asarray(a))

    def lin(self, name, p):  # kernel [in, out] -> weight [out, in]
        self.arr(f"{name}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.arr(f"{name}.bias", p["bias"])

    def conv(self, name, p):  # [k, in/g, out] -> [out, in/g, k]
        self.arr(f"{name}.weight", np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        if "bias" in p:
            self.arr(f"{name}.bias", p["bias"])

    def ln(self, name, p):
        self.arr(f"{name}.weight", p["weight"])
        self.arr(f"{name}.bias", p["bias"])

    def time_embed(self, p):
        self.lin("time_embed.time_mlp.0", p["mlp1"])
        self.lin("time_embed.time_mlp.2", p["mlp2"])

    def text_embed(self, p):
        self.arr("text_embed.text_embed.weight", p["embed"]["weight"])
        for i, bp in enumerate(p.get("blocks", [])):
            name = f"text_embed.text_blocks.{i}"
            self.conv(f"{name}.dwconv", bp["dwconv"])
            self.ln(f"{name}.norm", bp["norm"])
            self.lin(f"{name}.pwconv1", bp["pwconv1"])
            self.arr(f"{name}.grn.gamma", np.asarray(bp["grn"]["gamma"]).reshape(1, 1, -1))
            self.arr(f"{name}.grn.beta", np.asarray(bp["grn"]["beta"]).reshape(1, 1, -1))
            self.lin(f"{name}.pwconv2", bp["pwconv2"])

    def input_embed(self, base, lin_name, p):  # the input projection + ConvPositionEmbedding
        self.lin(f"{base}.{lin_name}", p["proj"])
        self.conv(f"{base}.conv_pos_embed.conv1d.0", p["conv_pos"]["conv1"])
        self.conv(f"{base}.conv_pos_embed.conv1d.2", p["conv_pos"]["conv2"])

    def attn(self, name, p, extra=()):
        for nm in ("to_q", "to_k", "to_v") + tuple(extra):
            self.lin(f"{name}.{nm}", p[nm])
        self.lin(f"{name}.to_out.0", p["to_out"])
        for nm in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
            if nm in p:
                self.arr(f"{name}.{nm}.weight", p[nm]["weight"])

    def ff(self, name, p):
        self.lin(f"{name}.ff.0.0", p["in"])
        self.lin(f"{name}.ff.2", p["out"])


def _layer(tree, i):
    """Layer ``i`` of a tree stacked on a leading depth axis."""
    return {k: (_layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]) for k, v in tree.items()}


def dit_state_from_jax_params(params: dict, cfg, prefix: str = "transformer."):
    """JAX ``models.dit`` params (blocks stacked on a leading depth axis) ->
    reference-named state dict of numpy arrays (mirrors ``dit_params_to_state``)."""
    w = _StateWriter(prefix)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    w.input_embed("input_embed", "proj", params["input_embed"])
    for i in range(cfg.depth):
        bp = _layer(params["blocks"], i)
        name = f"transformer_blocks.{i}"
        w.lin(f"{name}.attn_norm.linear", bp["attn_norm"]["linear"])
        w.attn(f"{name}.attn", bp["attn"])
        w.ff(f"{name}.ff", bp["ff"])
    w.lin("norm_out.linear", params["norm_out"]["linear"])
    w.lin("proj_out", params["proj_out"])
    if "long_skip" in params:
        w.lin("long_skip_connection", params["long_skip"])
    return w.out


def unett_state_from_jax_params(params: dict, cfg, prefix: str = "transformer."):
    """JAX ``models.unett`` params (two halves stacked on a leading axis) ->
    the reference UNetT state dict: ``layers.{i}.[0 skip_proj, 1 attn_norm,
    2 attn, 3 ff_norm, 4 ff]`` (the inverse of ``unett_params_from_state``)."""
    w = _StateWriter(prefix)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    w.input_embed("input_embed", "proj", params["input_embed"])
    half = cfg.depth // 2
    for i in range(cfg.depth):
        bp = _layer(params["first"] if i < half else params["second"], i % half)
        name = f"layers.{i}"
        if "skip_proj" in bp:
            w.lin(f"{name}.0", bp["skip_proj"])
        w.arr(f"{name}.1.g", bp["attn_norm"]["g"])
        w.attn(f"{name}.2", bp["attn"])
        w.arr(f"{name}.3.g", bp["ff_norm"]["g"])
        w.ff(f"{name}.4", bp["ff"])
    w.arr("norm_out.g", params["norm_out"]["g"])
    w.lin("proj_out", params["proj_out"])
    return w.out


def mmdit_state_from_jax_params(params: dict, cfg, prefix: str = "transformer."):
    """JAX ``models.mmdit`` params (blocks 0..depth-2 stacked, the
    ``context_pre_only`` last block apart) -> the reference MMDiT state dict
    (the inverse of ``mmdit_params_from_state``)."""
    w = _StateWriter(prefix)
    w.time_embed(params["time_embed"])
    w.text_embed(params["text_embed"])
    w.input_embed("audio_embed", "linear", params["audio_embed"])
    for i in range(cfg.depth):
        last = i == cfg.depth - 1
        bp = params["last_block"] if last else _layer(params["blocks"], i)
        name = f"transformer_blocks.{i}"
        w.lin(f"{name}.attn_norm_x.linear", bp["attn_norm_x"]["linear"])
        w.lin(f"{name}.attn_norm_c.linear", bp["attn_norm_c"]["linear"])
        w.attn(f"{name}.attn", bp["attn"], extra=("to_q_c", "to_k_c", "to_v_c"))
        if not last:
            w.lin(f"{name}.attn.to_out_c", bp["attn"]["to_out_c"])
            w.ff(f"{name}.ff_c", bp["ff_c"])
        w.ff(f"{name}.ff_x", bp["ff_x"])
    w.lin("norm_out.linear", params["norm_out"]["linear"])
    w.lin("proj_out", params["proj_out"])
    return w.out


_CONVERTERS = {"DiT": dit_state_from_jax_params, "UNetT": unett_state_from_jax_params,
               "MMDiT": mmdit_state_from_jax_params}


def state_from_jax_params(params: dict, cfg, prefix: str = "transformer."):
    """JAX backbone params -> the port's reference-named state dict,
    dispatching on ``cfg.backbone`` (so the JAX package's config objects
    serve as well as the port's), as JAX ``params_from_state`` does."""
    backbone = getattr(cfg, "backbone", "DiT")
    if backbone not in _CONVERTERS:
        raise ValueError(f"no converter for the {backbone!r} backbone")
    return _CONVERTERS[backbone](params, cfg, prefix)


def vocos_state_from_jax_params(params: dict) -> dict[str, np.ndarray]:
    """JAX ``models.vocos`` params -> charactr/vocos-mel-24khz state dict
    (the inverse of ``vocos_params_from_state``)."""
    out: dict[str, np.ndarray] = {}

    def lin(name, p):
        out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
        out[f"{name}.bias"] = np.asarray(p["bias"])

    def conv(name, p):
        out[f"{name}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        out[f"{name}.bias"] = np.asarray(p["bias"])

    def ln(name, p):
        out[f"{name}.weight"] = np.asarray(p["weight"])
        out[f"{name}.bias"] = np.asarray(p["bias"])

    conv("backbone.embed", params["embed"])
    ln("backbone.norm", params["norm"])
    for i, bp in enumerate(params["blocks"]):
        name = f"backbone.convnext.{i}"
        conv(f"{name}.dwconv", bp["dwconv"])
        ln(f"{name}.norm", bp["norm"])
        lin(f"{name}.pwconv1", bp["pwconv1"])
        lin(f"{name}.pwconv2", bp["pwconv2"])
        out[f"{name}.gamma"] = np.asarray(bp["gamma"])
    ln("backbone.final_layer_norm", params["final_norm"])
    lin("head.out", params["head"])
    return out


def bigvgan_state_from_jax_params(params: dict, cfg=None) -> dict[str, np.ndarray]:
    """JAX ``models.bigvgan`` params -> the reference generator state dict
    with fused weights (the inverse of ``bigvgan_params_from_state``)."""
    from f5_tts_tpu_torch.models.bigvgan import BigVGANConfig

    cfg = cfg or BigVGANConfig()
    out: dict[str, np.ndarray] = {}

    def conv(name, p):  # Conv1d [k, in, out] and ConvTranspose1d [k, out, in] alike
        out[f"{name}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(p["kernel"]),
                                                                  (2, 1, 0)))
        if "bias" in p:
            out[f"{name}.bias"] = np.asarray(p["bias"])

    n_res = len(cfg.resblock_kernel_sizes)
    conv("conv_pre", params["conv_pre"])
    for i, up in enumerate(params["ups"]):
        conv(f"ups.{i}.0", up)
        for j, rb in enumerate(params["resblocks"][i]):
            r = f"resblocks.{i * n_res + j}"
            for m, (c1, c2) in enumerate(zip(rb["convs1"], rb["convs2"])):
                conv(f"{r}.convs1.{m}", c1)
                conv(f"{r}.convs2.{m}", c2)
            for m in range(np.asarray(rb["alpha"]).shape[0]):
                out[f"{r}.activations.{m}.act.alpha"] = np.asarray(rb["alpha"][m])
                out[f"{r}.activations.{m}.act.beta"] = np.asarray(rb["beta"][m])
    out["activation_post.act.alpha"] = np.asarray(params["post_alpha"])
    out["activation_post.act.beta"] = np.asarray(params["post_beta"])
    conv("conv_post", params["conv_post"])
    return out
