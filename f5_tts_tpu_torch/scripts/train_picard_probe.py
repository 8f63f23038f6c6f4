"""Train F5TTS_v1_Base on a synthetic tone language, then A/B the
time-parallel (Picard) sampler against the sequential one on the trained
weights.

JAX counterpart: ``scripts/train_picard_probe.py``, with its corpus, its
arguments and its report.  Random weights pin every Picard tolerance at the
worst case (as many sweeps as steps); this gives the sampler weights whose
velocity field was trained:

1. A learnable dataset: each utterance is a sequence of pure tones keyed by
   its characters ('a'..'j' -> log-spaced frequencies, 14-26 characters,
   0.35 s each).
2. F5TTS_v1_Base at full width by default, trained with the port's
   ``Trainer`` in bf16 mixed precision with activation checkpointing, the
   mel taken on the card (kernels B, C, D, E), for ``--epochs`` epochs.
3. Generation from the final online weights (the EMA is still close to its
   initial snapshot at probe update counts) for held-out text, each
   character's dominant mel bin against its tone: tone accuracy and CER.
4. For each tolerance of ``--tols``: the sweeps ``cfm.sample`` takes at
   window ``--window``, evals per step, mel MAE against the sequential
   sampler on the same noise, and the projected eval ratio across cards
   (NFE / sweeps).  At ``--tol-main`` also the sequential and the one-card
   Picard RTF of the serving engines, each timed over replays of its
   captured CUDA graphs after the capture.

The weights are written with ``utils/ckpt.write_checkpoint`` under the
reference's key names; ``--skip-train`` loads them, ``--init-params``
continues training from them.  The last line is JAX's summary plus the
kernel launches of training (with its micro-steps) and of each Picard
sample (with its sweeps).

    python -m f5_tts_tpu_torch.scripts.train_picard_probe [--epochs 96] [--skip-train p.pt]
    python -m f5_tts_tpu_torch.scripts.train_picard_probe --tiny --device cpu --epochs 1
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

TONES = "abcdefghij"
SR = 24_000
CHAR_SECONDS = 0.35


def tone_freq(idx: int) -> float:
    return 220.0 * 2.0 ** (idx / 5.0)  # 220 Hz .. ~770 Hz, log-spaced


def synth_utterance(text: str, rng) -> np.ndarray:
    segs = []
    phase = 0.0
    n_seg = int(CHAR_SECONDS * SR)
    for ch in text:
        f = tone_freq(TONES.index(ch))
        t = np.arange(n_seg) / SR
        seg = 0.42 * np.sin(phase + 2 * np.pi * f * t)
        env = np.minimum(1.0, np.minimum(np.arange(n_seg), n_seg - np.arange(n_seg)) / (0.02 * SR))
        segs.append(seg * env)
        phase += 2 * np.pi * f * n_seg / SR
    wav = np.concatenate(segs)
    return (wav + 0.003 * rng.standard_normal(len(wav))).astype(np.float32)


def make_dataset(out_dir: str, n_files: int, rng) -> list[dict]:
    """JAX's rows and files; every utterance is synthesized, written or not,
    so later rows do not depend on which files the directory holds."""
    from f5_tts_tpu_torch.audio.io import save_wav

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i in range(n_files):
        n_chars = int(rng.integers(14, 27))
        text = "".join(TONES[j] for j in rng.integers(0, len(TONES), n_chars))
        path = os.path.join(out_dir, f"tone_{i}.wav")
        wav = synth_utterance(text, rng)
        if not os.path.isfile(path):
            save_wav(path, wav, SR)
        rows.append({"audio_path": path, "text": text, "duration": n_chars * CHAR_SECONDS})
    return rows


def dominant_tone(mel_seg: np.ndarray, mel_filter_freqs: np.ndarray) -> int:
    """Map a mel segment's peak bin to the nearest tone index."""
    prof = mel_seg.mean(axis=0)
    peak_bin = int(np.argmax(prof))
    f = mel_filter_freqs[peak_bin]
    return int(np.argmin([abs(f - tone_freq(i)) for i in range(len(TONES))]))


def probe_config(tiny: bool = False, dim: int = 0, depth: int = 0, heads: int = 0,
                 avg_upsample: bool = False):
    """JAX's probe ``ModelConfig``: F5TTS_v1_Base with byte tokens, or its
    ``--tiny`` / ``--dim`` narrowing."""
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = dataclasses.replace(MODEL_CONFIGS["F5TTS_v1_Base"], tokenizer="byte")
    if tiny:
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1))
    elif dim:
        heads = heads or max(2, dim // 64)
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, dim=dim, depth=depth or 8, heads=heads, dim_head=dim // heads))
    if avg_upsample:
        cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
            cfg.arch, text_embedding_average_upsampling=True))
    return cfg


def probe_prompt(mel_cfg) -> dict:
    """JAX's held-out prompt: a 6-character reference and 22 characters to
    generate (seed 1234), its mel, duration and byte ids."""
    from f5_tts_tpu_torch.ops.mel import log_mel_np

    rng = np.random.default_rng(1234)
    ref_text = "".join(TONES[j] for j in rng.integers(0, len(TONES), 6))
    gen_text = "".join(TONES[j] for j in rng.integers(0, len(TONES), 22))
    ref_mel = log_mel_np(synth_utterance(ref_text, rng), mel_cfg)[0]
    frames_per_char = CHAR_SECONDS * SR / mel_cfg.hop_length
    return {"ref_text": ref_text, "gen_text": gen_text, "ref_mel": ref_mel,
            "frames_per_char": frames_per_char,
            "duration": int(round((len(ref_text) + len(gen_text)) * frames_per_char)),
            "text_ids": np.frombuffer((ref_text + gen_text).encode(), np.uint8).astype(np.int32)}


def decode(gen_mel: np.ndarray, prompt: dict, freqs: np.ndarray) -> str:
    fpc = prompt["frames_per_char"]
    out = []
    for k in range(len(prompt["gen_text"])):
        seg = gen_mel[int(k * fpc) + 2:int((k + 1) * fpc) - 2]
        out.append(TONES[dominant_tone(seg, freqs)] if len(seg) else "?")
    return "".join(out)


def sample_inputs(prompt: dict, bucket: int, d: int) -> dict:
    """``raw_sample``'s inputs at ``bucket``: cond [1, bucket, d], tids, and
    the duration and reference length."""
    cond = np.zeros((1, bucket, d), np.float32)
    cond[0, :len(prompt["ref_mel"])] = prompt["ref_mel"]
    tids = np.full((1, bucket), -1, np.int32)
    tids[0, :len(prompt["text_ids"])] = prompt["text_ids"]
    return {"cond": cond, "tids": tids, "duration": np.asarray([prompt["duration"]], np.int32),
            "lens": np.asarray([len(prompt["ref_mel"])], np.int32)}


def raw_sample(backbone, arch, inputs: dict, noise: np.ndarray, nfe: int, window: int,
               tol: float | None, dtype):
    """``cfm.sample`` sequentially (``tol`` None) or by Picard at ``window``
    and ``tol`` -> (mel [1, bucket, d] fp32, {"sweeps", "window"})."""
    import torch

    from f5_tts_tpu_torch.models import cfm

    dev = next(backbone.parameters()).device
    opts = cfm.SampleOptions(steps=nfe, time_parallel_window=window if tol is not None else 0,
                             picard_tol=tol if tol is not None else 1e-3)

    def t(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    with torch.inference_mode():
        out, info = cfm.sample(backbone, arch, t(inputs["cond"], dtype), t(inputs["tids"]),
                               t(inputs["duration"]), t(noise, dtype), lens=t(inputs["lens"]),
                               opts=opts, backend="auto", return_info=True)
    return out.float().cpu().numpy(), info


def _replayed_wall(eng, prompt, iters: int) -> float:
    """Median wall of ``iters`` engine calls after the first (on the card the
    first captures the key's graphs; the others replay them)."""
    import torch

    args = ([prompt["ref_mel"]], [prompt["text_ids"]], [prompt["duration"]])
    eng.generate_batch(*args, seeds=[0], fetch_mel=False)
    walls = []
    for i in range(iters):
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        t0 = time.perf_counter()
        eng.generate_batch(*args, seeds=[i + 1], fetch_mel=False)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(prog="train_picard_probe")
    ap.add_argument("--epochs", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--files", type=int, default=192)
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tmp, "picard_probe_params.pt"))
    ap.add_argument("--data-dir", default=os.path.join(tmp, "picard_tone_ds"))
    ap.add_argument("--tols", default="3e-2,1e-2,1e-3", help="comma list of Picard tolerances")
    ap.add_argument("--tol-main", type=float, default=1e-3, dest="tol_main",
                    help="tolerance of the engine wall A/B")
    ap.add_argument("--iters", type=int, default=4, help="replayed engine calls timed")
    ap.add_argument("--skip-train", default=None,
                    help="saved weights (.pt): skip training")
    ap.add_argument("--init-params", default=None,
                    help="saved weights (.pt) to continue training from (fresh optimizer and "
                    "schedule)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="tiny arch smoke (CPU)")
    ap.add_argument("--dim", type=int, default=0,
                    help="arch width override (0 = Base); depth --depth or 8, heads --heads "
                    "or dim // 64")
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--heads", type=int, default=0)
    ap.add_argument("--avg-upsample", action="store_true", dest="avg_upsample",
                    help="text_embedding_average_upsampling: each character's embedding "
                    "spreads over its own frames, a local text -> tone map")
    args = ap.parse_args(argv)

    import torch

    from f5_tts_tpu_torch.eval.metrics import word_error_rate
    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine, pick_bucket
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.ops import cuda_build
    from f5_tts_tpu_torch.scripts.train_speak_probe import bin_freqs, load_params, save_params
    from f5_tts_tpu_torch.train.dataset import CustomDataset
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device, "train_picard_probe")
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    model_cfg = probe_config(args.tiny, args.dim, args.depth, args.heads, args.avg_upsample)
    arch, mel_cfg = model_cfg.arch, model_cfg.mel
    rows = make_dataset(args.data_dir, args.files if not args.tiny else 8,
                        np.random.default_rng(0))
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=mel_cfg)
    launches = {}

    # one module for both: the Trainer's loss reads its config (activation
    # checkpointing on), the samplers and engines take ``arch`` (off)
    train_cfg = dataclasses.replace(
        model_cfg, arch=dataclasses.replace(arch, checkpoint_activations=True))
    model = _seeded(lambda: CFM(train_cfg.arch), 0)
    if args.skip_train:
        load_params(model, args.skip_train)
        print(f"loaded params from {args.skip_train}", file=sys.stderr)
    else:
        if args.init_params:
            load_params(model, args.init_params)
            print(f"continuing from {args.init_params}", file=sys.stderr)
        with tempfile.TemporaryDirectory() as ck:
            tr = Trainer(
                train_cfg, None,
                OptimConfig(mixed_precision=on_card, learning_rate=args.lr,
                            num_warmup_updates=100,
                            total_updates=max(args.epochs * 16, 200)),
                ckpt_dir=ck, batch_size_per_device=8192 if not args.tiny else 2048,
                max_samples=16, save_per_updates=1_000_000, last_per_updates=1_000_000,
                seed=0, mel_in_graph=True, device=str(dev))
            tr.save_checkpoint = lambda *a, **k: None
            t0 = time.perf_counter()
            before = cuda_build.launch_counts()
            # generate from the final online weights: at probe update counts the
            # EMA (decay 0.9999) is still mostly the initial snapshot
            model, _, update = tr.train(model, ds, epochs=args.epochs, resume=False)
            launches["train"] = cuda_build.launches_since(before)
            launches["train_micro_steps"] = int(update)
            wall = time.perf_counter() - t0
            print(f"trained {update} updates in {wall:.0f}s", file=sys.stderr)
            launches["train_wall_s"] = wall
            with open(tr.log_file) as f:
                lines = [json.loads(x) for x in f]
            losses = [x["loss"] for x in lines if "loss" in x]
            if losses:
                print(f"loss trend: first20 {np.mean(losses[:20]):.4f} -> last20 "
                      f"{np.mean(losses[-20:]):.4f}", file=sys.stderr)
        save_params(model, args.out)
        print(f"params saved to {args.out}", file=sys.stderr)

    model = model.to(dev)
    backbone = copy.deepcopy(model.transformer).to(dtype).eval().requires_grad_(False)
    voc = _seeded(Vocos, 1).to(dev)
    sr = mel_cfg.target_sample_rate

    # ---- did it learn? generate from held-out text, check the tones
    prompt = probe_prompt(mel_cfg)
    freqs = bin_freqs(mel_cfg)
    eng_seq = InferenceEngine(copy.deepcopy(model), model_cfg, vocoder=voc, dtype=dtype,
                              options=EngineOptions(nfe_step=args.nfe))
    mels, _, _ = eng_seq.generate_batch([prompt["ref_mel"]], [prompt["text_ids"]],
                                        [prompt["duration"]], seeds=[0])
    decoded = decode(np.asarray(mels[0][len(prompt["ref_mel"]):], np.float32), prompt, freqs)
    gen_text = prompt["gen_text"]
    tone_acc = sum(a == b for a, b in zip(decoded, gen_text)) / len(gen_text)
    tone_cer = word_error_rate(gen_text, decoded, lang="zh")
    print(f"tone_accuracy (held-out text, NFE {args.nfe}): {tone_acc:.2f}; decoded "
          f"'{decoded}' vs '{gen_text}' -> CER {tone_cer:.2f}", file=sys.stderr)

    # ---- the engines at the main tolerance, timed over graph replays
    iters = args.iters if on_card else 1
    seq_wall = _replayed_wall(eng_seq, prompt, iters)
    eng_p = InferenceEngine(copy.deepcopy(model), model_cfg, vocoder=voc, dtype=dtype,
                            options=EngineOptions(nfe_step=args.nfe,
                                                  time_parallel_window=args.window,
                                                  picard_tol=args.tol_main))
    mels_p, _, _ = eng_p.generate_batch([prompt["ref_mel"]], [prompt["text_ids"]],
                                        [prompt["duration"]], seeds=[0])
    engine_sweeps = eng_p.last_sweeps
    pic_wall = _replayed_wall(eng_p, prompt, iters)
    engine_mae = float(np.abs(np.asarray(mels_p[0]) - np.asarray(mels[0])).mean())
    audio_s = prompt["duration"] * mel_cfg.hop_length / sr

    # ---- sequential against Picard over the tolerances, on one noise
    bucket = pick_bucket(prompt["duration"])
    inputs = sample_inputs(prompt, bucket, mel_cfg.n_mel_channels)
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn(inputs["cond"].shape, generator=gen, dtype=torch.float32).numpy()
    seq_raw, _ = raw_sample(backbone, arch, inputs, noise, args.nfe, args.window, None, dtype)
    reports = []
    launches["picard"] = {}
    for tol in [float(t) for t in args.tols.split(",")]:
        before = cuda_build.launch_counts()
        pic_raw, info = raw_sample(backbone, arch, inputs, noise, args.nfe, args.window, tol,
                                   dtype)
        sweeps = int(info["sweeps"])
        launches["picard"][str(tol)] = {"sweeps": sweeps, **cuda_build.launches_since(before)}
        rep = {
            "tol": tol,
            "sweeps": sweeps,
            "nfe": args.nfe,
            "evals_per_step": round(sweeps * min(args.window, args.nfe) / args.nfe, 2),
            "mel_mae_vs_sequential": round(float(np.abs(pic_raw - seq_raw).mean()), 5),
            # W cards integrate the window concurrently: per-card serial
            # forwards ~= sweeps (+ vocoder); sequential takes NFE
            "projected_multichip_eval_ratio": round(args.nfe / max(sweeps, 1), 2),
        }
        if tol == args.tol_main:
            rep["rtf_sequential"] = round(seq_wall / audio_s, 5)
            rep["rtf_picard_1chip"] = round(pic_wall / audio_s, 5)
            rep["engine_mel_mae"] = round(engine_mae, 5)
            rep["engine_sweeps"] = engine_sweeps
        reports.append(rep)
        print(json.dumps(rep), flush=True)

    summary = {
        "metric": "picard_trained_probe",
        "tone_accuracy": round(tone_acc, 3),
        "tone_cer": round(tone_cer, 3),
        "window": args.window,
        "best_sweeps": min(r["sweeps"] for r in reports),
        "sequential_worst_case": args.nfe,
        "depth": arch.depth,
        "launches": launches,
    }
    print(json.dumps(summary))
    return {"summary": summary, "reports": reports}


if __name__ == "__main__":
    main()
