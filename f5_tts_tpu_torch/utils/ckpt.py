"""Checkpoint loading, saving and export for the port, and the weight
carry-over to and from the JAX package's parameter trees.

JAX counterpart: ``f5_tts_tpu/utils/ckpt.py`` (``load_torch_state`` :31-64,
``dit_params_from_state`` :102-153, ``dit_params_to_state`` :156-210,
``unett_params_from_state`` :213-273, ``mmdit_params_from_state``
:276-331, the dispatch ``params_from_state`` :334-344,
``vocos_params_from_state`` :351-384, ``bigvgan_params_from_state``
:396-437 with ``_fused_weight`` :385-393, ``expand_text_embedding``
:445-464, ``export_safetensors`` :467-478, ``save_pytree`` /
``load_pytree`` :481-494, ``params_astype`` :497-501; JAX trains into
orbax checkpoints, the port into the reference's ``.pt`` layout).

The port's modules carry the reference's own parameter names for all three
backbones, so a released state dict loads into them directly:
``load_torch_state`` reads ``.pt`` / ``.safetensors`` files (the latter
through ``read_safetensors``, which needs no package), strips the EMA
prefix, picks the EMA or raw weights and drops bookkeeping keys;
``load_into`` loads by key and raises on any missing one.  BigVGAN's
release file (``bigvgan_generator.pt``) keeps its state dict under a
``"generator"`` key, which ``load_torch_state`` unwraps (JAX's does not, so
the file its hub resolves would not load there); ``load_bigvgan_state``
fuses weight-normed convs (``weight_g`` / ``weight_v``) as JAX does.

Training checkpoints: ``train_checkpoint`` builds the reference ``.pt``
layout, ``write_checkpoint`` writes it under a temporary name and renames
it into place, ``save_train_checkpoint`` does both now, and
``CheckpointWriter`` writes asynchronously (JAX: orbax's async save).

Interchange: ``state_from_jax_params`` (dispatching on the config's
backbone to the DiT, UNetT and MMDiT converters),
``vocos_state_from_jax_params`` and ``bigvgan_state_from_jax_params`` turn
the JAX package's canonical (unfused) parameter pytree, as nested dicts of
numpy arrays, into the port's reference-named state dict;
``jax_params_from_state``, ``vocos_jax_params_from_state`` and
``bigvgan_jax_params_from_state`` go the other way; ``stacked_leaf`` names
the stacked leaf a block's tensor lands in.  ``save_pytree`` /
``load_pytree`` write and read the JAX package's ``.npz`` snapshots (keyed
by each leaf's ``keystr`` path), so either package loads the other's.
``export_safetensors`` writes a reference release file
(``write_safetensors``, no package needed); ``expand_text_embedding`` grows
the text table for a larger vocabulary; ``params_astype`` casts.
"""

from __future__ import annotations

import os
import re
import threading

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
        state = read_safetensors(path)
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


def train_checkpoint(model: nn.Module | dict, ema_model: nn.Module | dict, optimizer_state: dict,
                     scheduler_state: dict, step: int, update: int,
                     extra: dict | None = None) -> dict:
    """A training checkpoint in the reference trainer's ``.pt`` layout, which
    ``load_torch_state`` reads (EMA or raw), holding the live tensors:
    ``model_state_dict``, ``ema_model_state_dict`` (ema_pytorch's keys:
    ``ema_model.``-prefixed weights plus ``initted`` and ``step``),
    ``optimizer_state_dict``, ``scheduler_state_dict`` and ``step``
    (micro-steps taken), plus ``extra``'s keys.  ``model`` and ``ema_model``
    may be given as their state dicts."""
    def sd(m):
        return m if isinstance(m, dict) else m.state_dict()

    ema = {"initted": torch.tensor(True), "step": torch.tensor(update)}
    ema.update({f"ema_model.{k}": v for k, v in sd(ema_model).items()})
    return {"model_state_dict": sd(model), "ema_model_state_dict": ema,
            "optimizer_state_dict": optimizer_state, "scheduler_state_dict": scheduler_state,
            "step": step, **(extra or {})}


def write_checkpoint(path: str, obj: dict) -> None:
    """``torch.save`` to a temporary name, then rename into place: a reader
    (and a crash mid-write) sees the previous file or the new one whole."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _map_tensors(obj, fn):
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def save_train_checkpoint(path: str, model: nn.Module, ema_model: nn.Module, optimizer_state: dict,
                          scheduler_state: dict, step: int, update: int,
                          extra: dict | None = None) -> None:
    """Write ``train_checkpoint(...)`` to ``path`` now (``write_checkpoint``)."""
    obj = train_checkpoint(model, ema_model, optimizer_state, scheduler_state, step, update, extra)
    write_checkpoint(path, _map_tensors(obj, lambda t: t.detach().cpu()))


class CheckpointWriter:
    """Asynchronous checkpoint writes (JAX: orbax's async save,
    ``train/trainer.py:209-279``).

    ``save(path, obj)`` first waits for the previous write, then takes a
    snapshot of ``obj``'s tensors: CUDA tensors are copied into pinned host
    buffers, allocated at the first save and reused after, by copies queued
    on the current stream, so they are ordered before any later kernel that
    updates the weights in place; CPU tensors are cloned.  A writer thread
    then waits for the copies and ``write_checkpoint``s the snapshot, then
    runs ``after`` (the trainer's rotation).  ``wait()`` blocks until the
    write is done and raises its error, if any; ``save(..., block=True)``
    writes before returning.
    """

    def __init__(self):
        self._pinned: dict[str, torch.Tensor] = {}
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._on_card = False

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _snapshot(self, obj, prefix: str = ""):
        if torch.is_tensor(obj):
            t = obj.detach()
            if t.device.type != "cuda":
                return t.clone()
            self._on_card = True
            buf = self._pinned.get(prefix)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._pinned[prefix] = buf
            return buf.copy_(t, non_blocking=True)
        if isinstance(obj, dict):
            return {k: self._snapshot(v, f"{prefix}/{k}") for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, f"{prefix}/{i}") for i, v in enumerate(obj))
        return obj

    def save(self, path: str, obj: dict, after=None, block: bool = False) -> None:
        self.wait()
        self._on_card = False
        snap = self._snapshot(obj)
        done = None
        if self._on_card:
            done = torch.cuda.Event()
            done.record()

        def write():
            try:
                if done is not None:
                    done.synchronize()
                write_checkpoint(path, snap)
                if after is not None:
                    after()
            except BaseException as e:  # noqa: BLE001 - raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._thread.start()
        if block:
            self.wait()


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


# ---------------------------------------------------------------------------
# the JAX package's parameter trees from a state dict (numpy), for its .npz


class _TreeReader:
    """JAX parameter leaves (numpy) from a reference-named state dict."""

    def __init__(self, state: dict):
        self.s = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
                  for k, v in state.items()}

    def arr(self, name):
        return self.s[name]

    def lin(self, name):  # weight [out, in] -> kernel [in, out]
        p = {"kernel": np.ascontiguousarray(self.s[f"{name}.weight"].T)}
        if f"{name}.bias" in self.s:
            p["bias"] = self.s[f"{name}.bias"]
        return p

    def conv(self, name, weight=None):  # [out, in/g, k] -> [k, in/g, out]
        w = self.s[f"{name}.weight"] if weight is None else weight
        p = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0)))}
        if f"{name}.bias" in self.s:
            p["bias"] = self.s[f"{name}.bias"]
        return p

    def ln(self, name):
        return {"weight": self.s[f"{name}.weight"], "bias": self.s[f"{name}.bias"]}

    def time_embed(self):
        return {"mlp1": self.lin("time_embed.time_mlp.0"), "mlp2": self.lin("time_embed.time_mlp.2")}

    def text_embed(self, conv_layers: int):
        p = {"embed": {"weight": self.arr("text_embed.text_embed.weight")}}
        if conv_layers > 0:
            p["blocks"] = [{
                "dwconv": self.conv(f"{b}.dwconv"), "norm": self.ln(f"{b}.norm"),
                "pwconv1": self.lin(f"{b}.pwconv1"),
                "grn": {"gamma": self.arr(f"{b}.grn.gamma").reshape(-1),
                        "beta": self.arr(f"{b}.grn.beta").reshape(-1)},
                "pwconv2": self.lin(f"{b}.pwconv2")}
                for b in (f"text_embed.text_blocks.{i}" for i in range(conv_layers))]
        return p

    def input_embed(self, base, lin_name):
        return {"proj": self.lin(f"{base}.{lin_name}"),
                "conv_pos": {"conv1": self.conv(f"{base}.conv_pos_embed.conv1d.0"),
                             "conv2": self.conv(f"{base}.conv_pos_embed.conv1d.2")}}

    def attn(self, name, extra=()):
        p = {nm: self.lin(f"{name}.{nm}") for nm in ("to_q", "to_k", "to_v") + tuple(extra)}
        p["to_out"] = self.lin(f"{name}.to_out.0")
        for nm in ("q_norm", "k_norm", "c_q_norm", "c_k_norm"):
            if f"{name}.{nm}.weight" in self.s:
                p[nm] = {"weight": self.arr(f"{name}.{nm}.weight")}
        return p

    def ff(self, name):
        return {"in": self.lin(f"{name}.ff.0.0"), "out": self.lin(f"{name}.ff.2")}


def _stack(trees: list):
    """Trees of one structure -> one tree stacked on a leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _backbone_state(state: dict) -> dict:
    if any(k.startswith("transformer.") for k in state):
        return {k[len("transformer."):]: v for k, v in state.items() if k.startswith("transformer.")}
    return state


def dit_jax_params_from_state(state: dict, cfg) -> dict:
    """The JAX ``models.dit`` tree (numpy) of a DiT state dict (JAX
    ``dit_params_from_state``)."""
    r = _TreeReader(_backbone_state(state))

    def block(i):
        b = f"transformer_blocks.{i}"
        return {"attn_norm": {"linear": r.lin(f"{b}.attn_norm.linear")},
                "attn": r.attn(f"{b}.attn"), "ff": r.ff(f"{b}.ff")}

    params = {"time_embed": r.time_embed(), "text_embed": r.text_embed(cfg.conv_layers),
              "input_embed": r.input_embed("input_embed", "proj"),
              "blocks": _stack([block(i) for i in range(cfg.depth)]),
              "norm_out": {"linear": r.lin("norm_out.linear")}, "proj_out": r.lin("proj_out")}
    if "long_skip_connection.weight" in r.s:
        params["long_skip"] = {"kernel": np.ascontiguousarray(
            r.arr("long_skip_connection.weight").T)}
    return params


def unett_jax_params_from_state(state: dict, cfg) -> dict:
    """The JAX ``models.unett`` tree (numpy) of a UNetT state dict (JAX
    ``unett_params_from_state``)."""
    r = _TreeReader(_backbone_state(state))

    def block(i, with_skip):
        b = f"layers.{i}"
        p = {"attn_norm": {"g": r.arr(f"{b}.1.g")}, "attn": r.attn(f"{b}.2"),
             "ff_norm": {"g": r.arr(f"{b}.3.g")}, "ff": r.ff(f"{b}.4")}
        if with_skip:
            p["skip_proj"] = {"kernel": np.ascontiguousarray(r.arr(f"{b}.0.weight").T)}
        return p

    half = cfg.depth // 2
    concat = cfg.skip_connect_type == "concat"
    return {"time_embed": r.time_embed(), "text_embed": r.text_embed(cfg.conv_layers),
            "input_embed": r.input_embed("input_embed", "proj"),
            "first": _stack([block(i, False) for i in range(half)]),
            "second": _stack([block(half + i, concat) for i in range(half)]),
            "norm_out": {"g": r.arr("norm_out.g")}, "proj_out": r.lin("proj_out")}


def mmdit_jax_params_from_state(state: dict, cfg) -> dict:
    """The JAX ``models.mmdit`` tree (numpy) of an MMDiT state dict (JAX
    ``mmdit_params_from_state``)."""
    r = _TreeReader(_backbone_state(state))

    def block(i):
        b = f"transformer_blocks.{i}"
        last = i == cfg.depth - 1
        p = {"attn_norm_x": {"linear": r.lin(f"{b}.attn_norm_x.linear")},
             "attn_norm_c": {"linear": r.lin(f"{b}.attn_norm_c.linear")},
             "attn": r.attn(f"{b}.attn", extra=("to_q_c", "to_k_c", "to_v_c")),
             "ff_x": r.ff(f"{b}.ff_x")}
        if not last:
            p["attn"]["to_out_c"] = r.lin(f"{b}.attn.to_out_c")
            p["ff_c"] = r.ff(f"{b}.ff_c")
        return p

    return {"time_embed": r.time_embed(),
            "text_embed": {"embed": {"weight": r.arr("text_embed.text_embed.weight")}},
            "audio_embed": r.input_embed("audio_embed", "linear"),
            "blocks": _stack([block(i) for i in range(cfg.depth - 1)]),
            "last_block": block(cfg.depth - 1),
            "norm_out": {"linear": r.lin("norm_out.linear")}, "proj_out": r.lin("proj_out")}


_TREES = {"DiT": dit_jax_params_from_state, "UNetT": unett_jax_params_from_state,
          "MMDiT": mmdit_jax_params_from_state}


_BLOCK_KEY = re.compile(r"(^|\.)transformer_blocks\.(\d+)\.(.+)$")


def stacked_leaf(name: str, cfg) -> str | None:
    """The leaf of the JAX package's tree that the state-dict tensor
    ``name`` is one depth slice of, where ``jax_params_from_state`` stacks
    blocks on a leading axis: every DiT block into ``blocks``, UNetT's two
    halves into ``first`` and ``second``, all of MMDiT's blocks but the last
    into ``blocks``.  None for a tensor that is a leaf of its own."""
    m = _BLOCK_KEY.search(name)
    if m is None:
        return None
    i, rest = int(m.group(2)), m.group(3)
    backbone = getattr(cfg, "backbone", "DiT")
    if backbone == "UNetT":
        return ("first." if i < cfg.depth // 2 else "second.") + rest
    if backbone == "MMDiT" and i == cfg.depth - 1:
        return None
    return "blocks." + rest


def jax_params_from_state(state: dict, cfg) -> dict:
    """A backbone state dict (``transformer.``-prefixed or bare) -> the JAX
    package's parameter tree for ``cfg``'s backbone, as numpy (JAX
    ``params_from_state``)."""
    backbone = getattr(cfg, "backbone", "DiT")
    if backbone not in _TREES:
        raise ValueError(f"no converter for the {backbone!r} backbone")
    return _TREES[backbone](state, cfg)


def vocos_jax_params_from_state(state: dict, num_layers: int = 8) -> dict:
    """The JAX ``models.vocos`` tree (numpy) of a Vocos state dict."""
    r = _TreeReader(state)
    blocks = [{"dwconv": r.conv(f"{b}.dwconv"), "norm": r.ln(f"{b}.norm"),
               "pwconv1": r.lin(f"{b}.pwconv1"), "pwconv2": r.lin(f"{b}.pwconv2"),
               "gamma": r.arr(f"{b}.gamma")}
              for b in (f"backbone.convnext.{i}" for i in range(num_layers))]
    return {"embed": r.conv("backbone.embed"), "norm": r.ln("backbone.norm"), "blocks": blocks,
            "final_norm": r.ln("backbone.final_layer_norm"), "head": r.lin("head.out")}


def bigvgan_jax_params_from_state(state: dict, cfg=None) -> dict:
    """The JAX ``models.bigvgan`` tree (numpy) of a BigVGAN generator state
    dict, weight-normed convs fused (JAX ``bigvgan_params_from_state``)."""
    from f5_tts_tpu_torch.models.bigvgan import BigVGANConfig

    cfg = cfg or BigVGANConfig()
    r = _TreeReader(fuse_weight_norm(state))
    n_res = len(cfg.resblock_kernel_sizes)
    ups, resblocks = [], []
    for i in range(len(cfg.upsample_rates)):
        ups.append(r.conv(f"ups.{i}.0"))  # ConvTranspose1d [in, out, k] -> [k, out, in]
        stage = []
        for j in range(n_res):
            rb = f"resblocks.{i * n_res + j}"
            n_d = len(cfg.resblock_dilation_sizes[j])
            stage.append({
                "convs1": [r.conv(f"{rb}.convs1.{m}") for m in range(n_d)],
                "convs2": [r.conv(f"{rb}.convs2.{m}") for m in range(n_d)],
                "alpha": np.stack([r.arr(f"{rb}.activations.{m}.act.alpha")
                                   for m in range(2 * n_d)]),
                "beta": np.stack([r.arr(f"{rb}.activations.{m}.act.beta")
                                  for m in range(2 * n_d)])})
        resblocks.append(stage)
    return {"conv_pre": r.conv("conv_pre"), "ups": ups, "resblocks": resblocks,
            "post_alpha": r.arr("activation_post.act.alpha"),
            "post_beta": r.arr("activation_post.act.beta"), "conv_post": r.conv("conv_post")}


# ---------------------------------------------------------------------------
# snapshots and release files


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]" for k in path)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield _keystr(path), np.asarray(tree)


def save_pytree(params: dict, path: str) -> None:
    """A flat ``.npz`` of a parameter tree (nested dicts and lists of
    arrays), keyed as the JAX package's ``save_pytree`` keys it (the
    ``keystr`` of each leaf's path), so either package loads the other's."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **dict(_flatten(params)))


def _parse_keystr(key: str) -> list:
    import ast

    if not (key.startswith("[") and key.endswith("]")):
        raise ValueError(f"not a keystr path: {key!r}")
    return [ast.literal_eval(part) for part in key[1:-1].split("][")]


def load_pytree(path: str) -> dict:
    """A ``save_pytree`` ``.npz`` (either package's) -> the nested tree of
    numpy arrays (lists where the path holds indices)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node, parts = root, _parse_keystr(key)
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]

    def listify(t):
        if not isinstance(t, dict):
            return t
        t = {k: listify(v) for k, v in t.items()}
        if t and all(isinstance(k, int) for k in t):
            return [t[i] for i in range(len(t))]
        return t

    return listify(root)


def backbone_state_from_npz(path: str, cfg) -> dict:
    """A backbone ``.npz`` snapshot -> its reference-named state dict."""
    return state_from_jax_params(load_pytree(path), cfg, prefix="")


def expand_text_embedding(state: dict, new_vocab_size: int, seed: int = 0) -> dict:
    """Grow the text embedding table for an extended vocabulary (reference
    finetune_gradio ``expand_model_embeddings``; JAX ``expand_text_embedding``):
    the existing rows are kept, new rows drawn from N(0, 0.02) (a torch
    generator seeded ``seed``; JAX draws its own).  ``new_vocab_size``
    excludes the filler row.  ``state`` is a backbone or CFM state dict."""
    key = next(k for k in state if k.endswith("text_embed.text_embed.weight"))
    emb = torch.as_tensor(state[key])
    rows = new_vocab_size + 1
    if emb.shape[0] >= rows:
        return state
    g = torch.Generator().manual_seed(seed)
    extra = torch.randn((rows - emb.shape[0], emb.shape[1]), generator=g).to(emb.dtype) * 0.02
    return {**state, key: torch.cat([emb, extra], dim=0)}


def params_astype(state: dict, dtype) -> dict:
    """Floating tensors cast to ``dtype`` (fp32 master weights -> bf16
    inference weights); the rest unchanged."""
    return {k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v)
            for k, v in state.items()}


_ST_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
              torch.float64: "F64", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
              torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_ST_TORCH = {v: k for k, v in _ST_DTYPES.items()}


def write_safetensors(tensors: dict, path: str, metadata: dict | None = None) -> None:
    """The safetensors format, written directly (no package needed): an
    8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and byte range (names sorted, ranges contiguous), padded
    with spaces to 8 bytes, then the raw little-endian bytes."""
    import json

    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        raw = t.view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
        data = raw.numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)
    os.replace(tmp, path)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file -> {name: CPU tensor} (no package needed)."""
    import json

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        body = bytearray(f.read())
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        start, end = spec["data_offsets"]
        dtype = _ST_TORCH[spec["dtype"]]
        raw = torch.frombuffer(body, dtype=torch.uint8, offset=start, count=end - start) \
            if end > start else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(spec["shape"]).clone()
    return out


def export_safetensors(state: dict, path: str, ema_prefix: bool = True) -> None:
    """A reference-format release file of a CFM's weights (JAX
    ``export_safetensors``): the ``transformer.*`` state, each key prefixed
    ``ema_model.`` (the released files' layout) unless ``ema_prefix`` is
    False.  ``state`` is a CFM state dict or a bare backbone's (any of the
    three backbones: the port's modules carry the reference names)."""
    if not any(k.startswith("transformer.") for k in state):
        state = {f"transformer.{k}": v for k, v in state.items()}
    pre = "ema_model." if ema_prefix else ""
    write_safetensors({pre + k: v for k, v in state.items() if k.startswith("transformer.")}, path)
