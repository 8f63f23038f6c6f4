"""The system under test, built from a configuration file: the port's
``CFM`` model and Vocos made on the device with ``weights.fill_``, and the
serving engine, and the training step's optimizer, schedule and EMA.  The only module of the benchmark that imports the
program."""

from __future__ import annotations

import copy

import torch

from benchmark import weights


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from f5_tts_tpu_torch.models.configs import DiTConfig, ModelConfig, UNetTConfig
    from f5_tts_tpu_torch.ops.mel import MelConfig

    cls = DiTConfig if cfg["backbone"] == "DiT" else UNetTConfig
    arch = cls(**cfg["arch"])
    return ModelConfig(name=cfg["model"], arch=arch, mel=MelConfig(**cfg["mel_spec"]),
                       tokenizer="char")


def seeds(seed: int) -> tuple[int, int, int]:
    """The backbone's, the vocoder's and the training EMA's weight seeds of a run."""
    return seed % 2**63, (seed * 2654435761 + 1) % 2**63, (seed * 40503 + 7) % 2**63


def build_model(cfg: dict, seed: int, device):
    """(model_cfg, CFM on ``device`` in fp32 with seeded weights)."""
    from f5_tts_tpu_torch.models.cfm import CFM

    mcfg = model_config(cfg)
    with torch.device("meta"):
        model = CFM(mcfg.arch)
    model = model.to_empty(device=device)
    weights.fill_(model, seeds(seed)[0])
    return mcfg, model


def build_ema(model, seed: int):
    """The EMA copy of ``model`` a resumed run holds: the backbone's shapes,
    its own weights drawn from the run's seed (not the online weights)."""
    ema = copy.deepcopy(model).requires_grad_(False)
    weights.fill_(ema, seeds(seed)[2])
    return ema


def optim_config(cfg: dict, total_updates: int, mixed_precision: bool):
    """The program's ``OptimConfig`` of the configuration's ``optim`` and
    ``ema`` sections."""
    from f5_tts_tpu_torch.train.step import OptimConfig

    o, e = cfg["optim"], cfg["ema"]
    return OptimConfig(learning_rate=o["learning_rate"],
                       num_warmup_updates=o["num_warmup_updates"], total_updates=total_updates,
                       max_grad_norm=o["max_grad_norm"],
                       grad_accumulation_steps=o["grad_accumulation_steps"],
                       ema_decay=e["decay"], ema_update_after_step=e["update_after_step"],
                       ema_update_every=e["update_every"], mixed_precision=mixed_precision)


def resume_schedule(optimizer, opt_cfg, update: int) -> None:
    """Put the optimizer's learning-rate schedule where a run resumed after
    ``update`` updates has it (the scheduler state a checkpoint restores);
    AdamW's moments start empty."""
    from f5_tts_tpu_torch.train.step import lr_schedule

    lr = lr_schedule(opt_cfg)(update)
    sch = optimizer.scheduler
    groups = optimizer.inner.param_groups
    sch.load_state_dict({**sch.state_dict(), "last_epoch": update, "_step_count": update + 1,
                         "_last_lr": [lr] * len(groups)})
    for g in groups:
        g["lr"] = lr


# bits of the dtypes a weight can be held in below bf16, and of the stated ones
_BITS = {torch.float64: 64, torch.float32: 32, torch.bfloat16: 16, torch.float16: 16,
         torch.int8: 8, torch.uint8: 8, torch.qint8: 8, torch.quint8: 8, torch.quint4x2: 4,
         **{getattr(torch, n): 8 for n in ("float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
                                            "float8_e5m2fnuz") if hasattr(torch, n)}}
_STATED = {"fp32": 32, "bf16": 16, "fp16": 16}


def below_precision(engine, cfg: dict) -> int:
    """How far the serving engine departs from the configuration's stated
    precision: its tensors (parameters and buffers) held in fewer bits than
    the configuration states for the backbone or the vocoder, plus one if
    the engine's W8A8 option is on.  0 for an engine run as stated."""
    n = int(bool(engine.options.quantize))
    for module, key in ((engine.model, "backbone"), (engine.vocoder, "vocoder")):
        stated = _STATED[cfg["precision"][key]]
        for t in (*module.parameters(), *module.buffers()):
            n += _BITS.get(t.dtype, 64) < stated
    return n


def build_vocoder(cfg: dict, seed: int, device):
    from f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig

    v = cfg["vocoder"]
    vc = VocosConfig(dim=v["dim"], intermediate_dim=v["intermediate_dim"],
                     num_layers=v["num_layers"], n_fft=v["n_fft"], hop_length=v["hop_length"])
    with torch.device("meta"):
        voc = Vocos(vc)
    voc = voc.to_empty(device=device)
    weights.fill_(voc, seeds(seed)[1])
    return voc


def build_engine(cfg: dict, seed: int, device, nfe: int, cfg_strength: float, sway: float,
                 quantize: bool = False):
    """The serving engine: the backbone in the configuration's dtype (bf16
    on the card), Vocos in fp32, the configuration's buckets.  ``quantize``
    switches on the program's W8A8 path, for the correctness control only
    (``below_precision`` then reads it)."""
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine

    mcfg, model = build_model(cfg, seed, device)
    voc = build_vocoder(cfg, seed, device)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    opts = EngineOptions(nfe_step=nfe, cfg_strength=cfg_strength, sway_sampling_coef=sway,
                         quantize=quantize)
    return InferenceEngine(model, mcfg, vocoder=voc, dtype=dtype,
                           buckets=tuple(cfg["serving"]["buckets"]), options=opts)
