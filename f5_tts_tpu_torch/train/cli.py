"""Pretraining CLI (reference src/f5_tts/train/train.py).

JAX counterpart: ``f5_tts_tpu/train/cli.py:14-206``.  Reads the reference
YAML schema (``configs/*.yaml``) through a stdlib subset parser, or a
builtin config, applies hydra-style dotted overrides and runs the
``Trainer`` on the card (``--device cuda``, the default).  Under
``torchrun`` (``WORLD_SIZE`` > 1) every process joins the group
(``parallel/distributed.init_distributed``) and the trainer gets a mesh of
``WORLD_SIZE / S`` data ranks by ``S = --sequence_parallel`` seq ranks, as
JAX :159-190; ``--zero1`` shards AdamW's moments over the data ranks.
``--tensor_parallel`` and ``--pipeline_parallel`` above 1 (and
``--pipeline_microbatches``) are the next slice and raise.

    torchrun --nproc_per_node=4 -m f5_tts_tpu_torch.train.cli --sequence_parallel 2 --zero1

``--pretrain`` loads a
reference ``.pt`` / ``.safetensors`` checkpoint or a JAX-layout ``.npz``.
The dataset comes from ``data/<name>_<tokenizer>/``
(``train/dataset.load_dataset``).

    python -m f5_tts_tpu_torch.train.cli --config configs/F5TTS_v1_Base.yaml
    python -m f5_tts_tpu_torch.train.cli --config configs/E2TTS_Base.yaml
    python -m f5_tts_tpu_torch.train.cli --model F5TTS_MMDiT_Base

Any of the three backbones (DiT, UNetT, MMDiT) trains; ``cfm.loss``
dispatches on the config.
"""

from __future__ import annotations

import argparse


def parse_simple_yaml(path: str) -> dict:
    """Minimal YAML subset parser (nested maps, scalars): enough for the
    reference config schema, with no yaml dependency."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(-1, root)]
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            indent = len(line) - len(line.lstrip())
            key, _, val = line.strip().partition(":")
            val = val.strip()
            while stack and stack[-1][0] >= indent:
                stack.pop()
            parent = stack[-1][1]
            if not val:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = _scalar(val)
    return root


def _scalar(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v.strip("'\"")


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Hydra-style ``[++]section.key=value`` overrides over the parsed config,
    in place; ``[a,b]`` parses to a list of scalars."""
    for item in overrides:
        spec = item[2:] if item.startswith("++") else item
        path, eq, raw = spec.partition("=")
        if not eq or "." not in path:
            raise SystemExit(f"bad override {item!r}: expected [++]section.key=value")
        value = ([_scalar(x.strip()) for x in raw[1:-1].split(",") if x.strip()]
                 if raw.startswith("[") and raw.endswith("]") else _scalar(raw))
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            nxt = node.get(k)
            if not isinstance(nxt, dict):
                nxt = {}
                node[k] = nxt
            node = nxt
        node[keys[-1]] = value
    return cfg


def load_pretrained(path: str, arch_cfg) -> dict:
    """The state dict of a ``--pretrain`` file: a reference ``.pt`` /
    ``.safetensors`` checkpoint (its EMA weights) or a JAX-layout backbone
    ``.npz`` snapshot (JAX ``cli.py:194-196``)."""
    from f5_tts_tpu_torch.utils import ckpt as ckpt_util

    if path.endswith(".npz"):
        return ckpt_util.backbone_state_from_npz(path, arch_cfg)
    return ckpt_util.load_torch_state(path)


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_train (PyTorch)")
    p.add_argument("--config", type=str, help="YAML config (reference schema)")
    p.add_argument("--model", type=str, default="F5TTS_v1_Base", help="builtin config name")
    p.add_argument("--dataset_name", type=str, default="Emilia_ZH_EN")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--batch_size_per_gpu", type=int, default=None)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--num_warmup_updates", type=int, default=None)
    p.add_argument("--tensor_parallel", type=int, default=1)
    p.add_argument("--pipeline_parallel", type=int, default=1)
    p.add_argument("--pipeline_microbatches", type=int, default=0)
    p.add_argument("--sequence_parallel", type=int, default=1)
    p.add_argument("--zero1", action="store_true")
    p.add_argument("--pretrain", type=str, default=None,
                   help="init weights (.pt / .safetensors / .npz)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", metavar="[++]section.key=value",
                   help="hydra-style dotted overrides over the YAML / builtin config")
    args = p.parse_args(argv)
    if args.tensor_parallel > 1 or args.pipeline_parallel > 1 or args.pipeline_microbatches:
        raise SystemExit("tensor and pipeline parallel training are not ported yet: they are the "
                         "next slice of the port (see ROADMAP.md)")
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % args.sequence_parallel:
        raise SystemExit(f"--sequence_parallel {args.sequence_parallel} needs a multiple of "
                         f"{args.sequence_parallel} processes (torchrun --nproc_per_node); "
                         f"WORLD_SIZE is {world}")

    import torch

    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import (MODEL_CONFIGS, from_yaml_dict, to_yaml_dict,
                                                 with_vocab_size)
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train.dataset import load_dataset
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer
    from f5_tts_tpu_torch.utils import ckpt as ckpt_util

    ycfg = parse_simple_yaml(args.config) if args.config else {}
    if args.overrides:
        if "model" not in ycfg and any(o.lstrip("+").startswith("model.") for o in args.overrides):
            ycfg["model"] = to_yaml_dict(MODEL_CONFIGS[args.model])
        apply_overrides(ycfg, args.overrides)
    model_section = ycfg.get("model", {})
    model_cfg = from_yaml_dict(model_section) if model_section else MODEL_CONFIGS[args.model]
    optim = ycfg.get("optim", {})
    datasets_cfg = ycfg.get("datasets", {})
    ckpts_cfg = ycfg.get("ckpts", {})

    mesh = None
    if world > 1:  # JAX :159-168: data = world / (tp * pp * sp)
        from f5_tts_tpu_torch.parallel.distributed import init_distributed
        from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

        init_distributed(device=args.device)
        mesh = make_train_mesh(data=world // args.sequence_parallel, seq=args.sequence_parallel)
    dataset_name = datasets_cfg.get("name", args.dataset_name)
    vocab, vocab_size = get_tokenizer(dataset_name, model_cfg.tokenizer)
    model_cfg = with_vocab_size(model_cfg, vocab_size)
    epochs = args.epochs or optim.get("epochs", 11)
    opt_cfg = OptimConfig(
        learning_rate=args.learning_rate or optim.get("learning_rate", 7.5e-5),
        num_warmup_updates=args.num_warmup_updates or optim.get("num_warmup_updates", 20_000),
        max_grad_norm=optim.get("max_grad_norm", 1.0),
        grad_accumulation_steps=optim.get("grad_accumulation_steps", 1),
        mixed_precision=optim.get("mixed_precision", False),
    )
    trainer = Trainer(
        model_cfg, vocab, opt_cfg,
        ckpt_dir=args.ckpt_dir or ckpts_cfg.get("save_dir", f"ckpts/{model_cfg.name}"),
        batch_size_per_device=args.batch_size_per_gpu or datasets_cfg.get("batch_size_per_gpu",
                                                                          38_400),
        batch_size_type=datasets_cfg.get("batch_size_type", "frame"),
        max_samples=args.max_samples or datasets_cfg.get("max_samples", 64),
        save_per_updates=ckpts_cfg.get("save_per_updates", 50_000),
        keep_last_n_checkpoints=ckpts_cfg.get("keep_last_n_checkpoints", -1),
        last_per_updates=ckpts_cfg.get("last_per_updates", 5_000),
        logger=ckpts_cfg.get("logger"),
        mesh=mesh,
        seed=666,
        zero1=args.zero1,
        sequence_parallel=args.sequence_parallel > 1,
        device=args.device,
    )
    dataset = load_dataset(dataset_name, model_cfg.tokenizer, mel_cfg=model_cfg.mel,
                           data_root=args.data_root)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CFM(model_cfg.arch)
    if args.pretrain:
        ckpt_util.load_dit_state(model, load_pretrained(args.pretrain, model_cfg.arch))
    trainer.train(model, dataset, epochs=epochs, resume=True)


if __name__ == "__main__":
    main()
