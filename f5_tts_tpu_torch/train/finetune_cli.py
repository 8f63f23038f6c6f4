"""Finetuning CLI (reference src/f5_tts/train/finetune_cli.py:81-210).

JAX counterpart: ``f5_tts_tpu/train/finetune_cli.py:18-119``, with the same
flags plus ``--device`` (``cuda``, the default, or ``cpu``).  ``--pretrain``
points at a local checkpoint (``.pt`` / ``.safetensors`` / a JAX-layout
``.npz``); it is copied into the run's directory ``ckpts/<dataset_name>``
as ``pretrained_<name>`` (which checkpoint rotation never touches) and
loaded from there.  A vocabulary larger than the checkpoint's embedding
table (``--tokenizer custom``) grows the table (``expand_text_embedding``).
``--export_safetensors`` writes the final EMA weights as a reference-format
release file.

    python -m f5_tts_tpu_torch.train.finetune_cli --exp_name F5TTS_v1_Base \\
        --dataset_name my_speak --pretrain model_1250000.safetensors \\
        --export_safetensors finetuned.safetensors
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    p = argparse.ArgumentParser(prog="f5-tts_finetune-cli (PyTorch)")
    p.add_argument("--exp_name", type=str, default="F5TTS_v1_Base", choices=sorted(MODEL_CONFIGS))
    p.add_argument("--dataset_name", type=str, default="my_speak")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--pretrain", type=str, default=None, help="local pretrained ckpt path")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--batch_size_per_gpu", type=int, default=3200)
    p.add_argument("--batch_size_type", type=str, default="frame", choices=["frame", "sample"])
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_warmup_updates", type=int, default=20000)
    p.add_argument("--save_per_updates", type=int, default=50000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--last_per_updates", type=int, default=5000)
    p.add_argument("--finetune", action="store_true", default=True)
    p.add_argument("--tokenizer", type=str, default=None, choices=[None, "pinyin", "char", "custom"])
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--logger", type=str, default=None, choices=[None, "wandb", "tensorboard"])
    p.add_argument("--export_safetensors", type=str, default=None,
                   help="write the final EMA weights as a reference-format .safetensors")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.configs import with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.train import dataset as D
    from f5_tts_tpu_torch.train.cli import load_pretrained
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer
    from f5_tts_tpu_torch.utils import ckpt as ckpt_util

    model_cfg = MODEL_CONFIGS[args.exp_name]
    tokenizer = args.tokenizer or model_cfg.tokenizer
    vocab_src = args.tokenizer_path if tokenizer == "custom" else args.dataset_name
    vocab, vocab_size = get_tokenizer(vocab_src, tokenizer)

    ckpt_dir = os.path.join("ckpts", args.dataset_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    state = None
    if args.pretrain:
        # snapshot the pretrained weights into the run directory (reference :141-151)
        dst = os.path.join(ckpt_dir, f"pretrained_{os.path.basename(args.pretrain)}")
        if not os.path.exists(dst):
            shutil.copy2(args.pretrain, dst)
        state = load_pretrained(dst, with_vocab_size(model_cfg, vocab_size).arch)
        # an extended vocabulary grows the table (reference expand_model_embeddings)
        state = ckpt_util.expand_text_embedding(state, vocab_size)
        rows = next(v for k, v in state.items() if k.endswith("text_embed.text_embed.weight"))
        vocab_size = max(vocab_size, rows.shape[0] - 1)  # a larger table is kept, as in JAX
    model_cfg = with_vocab_size(model_cfg, vocab_size)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = CFM(model_cfg.arch)
    if state is not None:
        ckpt_util.load_dit_state(model, state)

    dataset = D.load_dataset(args.dataset_name, tokenizer, mel_cfg=model_cfg.mel,
                             data_root=args.data_root)
    trainer = Trainer(
        model_cfg, vocab,
        OptimConfig(learning_rate=args.learning_rate, num_warmup_updates=args.num_warmup_updates,
                    max_grad_norm=args.max_grad_norm),
        ckpt_dir=ckpt_dir, batch_size_per_device=args.batch_size_per_gpu,
        batch_size_type=args.batch_size_type, max_samples=args.max_samples,
        grad_accumulation_steps=args.grad_accumulation_steps,
        save_per_updates=args.save_per_updates,
        keep_last_n_checkpoints=args.keep_last_n_checkpoints,
        last_per_updates=args.last_per_updates, logger=args.logger, device=args.device)
    _, ema_model, update = trainer.train(model, dataset, epochs=args.epochs, resume=True)
    if args.export_safetensors:
        ckpt_util.export_safetensors(ema_model.state_dict(), args.export_safetensors)
        print(f"exported EMA weights -> {args.export_safetensors}")
    return update


if __name__ == "__main__":
    main()
