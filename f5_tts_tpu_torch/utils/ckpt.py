"""Checkpoint loading for the port, and the weight carry-over from the JAX
package's parameter trees.

JAX counterpart: ``f5_tts_tpu/utils/ckpt.py`` (``load_torch_state`` :31-64,
``dit_params_from_state`` :102-153, ``dit_params_to_state`` :156-210,
``vocos_params_from_state`` :351-384).  The port's modules carry the
reference's own parameter names, so a released state dict loads into them
directly: ``load_torch_state`` reads ``.pt`` / ``.safetensors`` files,
strips the EMA prefix, picks the EMA or raw weights and drops bookkeeping
keys; ``load_into`` loads by key and raises on any missing one.

``state_from_jax_params`` / ``vocos_state_from_jax_params`` turn the JAX
package's canonical (unfused) parameter pytree, as nested dicts of numpy
arrays, into the port's reference-named state dict (pure numpy; the tests
use them to give both implementations the same weights).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from f5_tts_tpu_torch.models.configs import DiTConfig

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


def load_dit_state(cfm: nn.Module, state: dict) -> nn.Module:
    """Load a CFM state dict (``transformer.*``) or a bare DiT state dict."""
    if any(k.startswith("transformer.") for k in state):
        return load_into(cfm, state)
    return load_into(cfm.transformer, state)


# ---------------------------------------------------------------------------
# weight carry-over from the JAX parameter pytree


def state_from_jax_params(params: dict, cfg: DiTConfig, prefix: str = "transformer."):
    """JAX ``models.dit`` params (blocks stacked on a leading depth axis) ->
    reference-named state dict of numpy arrays (mirrors ``dit_params_to_state``)."""
    out: dict[str, np.ndarray] = {}

    def put_lin(name, p):
        out[f"{prefix}{name}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
        if "bias" in p:
            out[f"{prefix}{name}.bias"] = np.asarray(p["bias"])

    def put_conv(name, p):  # [k, in/g, out] -> [out, in/g, k]
        out[f"{prefix}{name}.weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        if "bias" in p:
            out[f"{prefix}{name}.bias"] = np.asarray(p["bias"])

    def put_ln(name, p):
        out[f"{prefix}{name}.weight"] = np.asarray(p["weight"])
        out[f"{prefix}{name}.bias"] = np.asarray(p["bias"])

    put_lin("time_embed.time_mlp.0", params["time_embed"]["mlp1"])
    put_lin("time_embed.time_mlp.2", params["time_embed"]["mlp2"])
    out[f"{prefix}text_embed.text_embed.weight"] = np.asarray(params["text_embed"]["embed"]["weight"])
    for i, bp in enumerate(params["text_embed"].get("blocks", [])):
        name = f"text_embed.text_blocks.{i}"
        put_conv(f"{name}.dwconv", bp["dwconv"])
        put_ln(f"{name}.norm", bp["norm"])
        put_lin(f"{name}.pwconv1", bp["pwconv1"])
        out[f"{prefix}{name}.grn.gamma"] = np.asarray(bp["grn"]["gamma"]).reshape(1, 1, -1)
        out[f"{prefix}{name}.grn.beta"] = np.asarray(bp["grn"]["beta"]).reshape(1, 1, -1)
        put_lin(f"{name}.pwconv2", bp["pwconv2"])
    put_lin("input_embed.proj", params["input_embed"]["proj"])
    put_conv("input_embed.conv_pos_embed.conv1d.0", params["input_embed"]["conv_pos"]["conv1"])
    put_conv("input_embed.conv_pos_embed.conv1d.2", params["input_embed"]["conv_pos"]["conv2"])
    blocks = params["blocks"]
    for i in range(cfg.depth):
        def at(tree, i=i):
            return {k: (at(v) if isinstance(v, dict) else np.asarray(v)[i]) for k, v in tree.items()}

        bp = at(blocks)
        name = f"transformer_blocks.{i}"
        put_lin(f"{name}.attn_norm.linear", bp["attn_norm"]["linear"])
        for nm in ("to_q", "to_k", "to_v"):
            put_lin(f"{name}.attn.{nm}", bp["attn"][nm])
        put_lin(f"{name}.attn.to_out.0", bp["attn"]["to_out"])
        if "q_norm" in bp["attn"]:
            out[f"{prefix}{name}.attn.q_norm.weight"] = bp["attn"]["q_norm"]["weight"]
            out[f"{prefix}{name}.attn.k_norm.weight"] = bp["attn"]["k_norm"]["weight"]
        put_lin(f"{name}.ff.ff.0.0", bp["ff"]["in"])
        put_lin(f"{name}.ff.ff.2", bp["ff"]["out"])
    put_lin("norm_out.linear", params["norm_out"]["linear"])
    put_lin("proj_out", params["proj_out"])
    if "long_skip" in params:
        out[f"{prefix}long_skip_connection.weight"] = np.ascontiguousarray(
            np.asarray(params["long_skip"]["kernel"]).T)
    return out


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
