"""Train a small DiT with the port's Trainer until it demonstrably speaks.

JAX counterpart: ``scripts/train_speak_probe.py``, with its corpus, its
held-out set, its decoding, its seeds and its arguments.  The corpus is
built for learnable alignment at probe scale:

- an 8-character vocabulary ('a'..'h' -> log-spaced pure tones, 220..1750
  Hz), i.i.d. random sequences, so the unconditional marginal carries no
  order information;
- short utterances (4-10 characters) of exactly 0.32 s per character (30
  mel frames at hop 256: character k fills frames [30k, 30k + 30));
- ``text_embedding_average_upsampling``, so each character's embedding
  spreads over its own frames and the text -> tone map is local;
- a small DiT (default dim 128, depth 4, ~4M parameters) that cannot
  descend the loss by memorizing the corpus.

Training runs the port's ``Trainer`` (bf16 mixed precision on the card,
mel taken on the card from the decoded waveforms).  At every
``--eval-every`` updates the Trainer's ``log_samples_fn`` hook samples the
held-out texts with ``cfm.sample`` on the online weights (the EMA is still
near its initial snapshot at probe update counts) and decodes each
character back by its dominant mel bin; CER comes from
``eval.metrics.word_error_rate``.  Below ``--target-cer`` the hook stops
training through the Trainer's SIGTERM route (the step finishes,
``model_last.pt`` is written, ``train`` returns).  Then an order-sensitivity
diagnostic (velocity MSE for the correct against shuffled text at t =
0.05) and a final pass through the serving engine (``InferenceEngine``,
CUDA graphs on the card, Vocos), whose CER is reported too.  The weights
are written with ``utils/ckpt.write_checkpoint`` under the reference's key
names (``transformer.*``); ``--skip-train`` loads such a file.

The attention and ConvPositionEmbedding follow the shape gates
(``ops/attention.attention_takes_kernel``, ``models/layers.py``
``conv_pos_takes_kernel``): at the default dh 32 both run their plain
versions on the card, as JAX ran SDPA and XLA's convs on the TPU; at
``--heads 2`` (dh 64) training runs kernels C, D, E and sampling kernel A.
The ConvPositionEmbedding's 8-channel groups always run plain.  The last
line is JAX's JSON plus the kernel launches of training, of the evals and
of the engine pass.

    python -m f5_tts_tpu_torch.scripts.train_speak_probe                # full probe
    python -m f5_tts_tpu_torch.scripts.train_speak_probe --heads 2      # on the kernels
    python -m f5_tts_tpu_torch.scripts.train_speak_probe --skip-train p.pt
    python -m f5_tts_tpu_torch.scripts.train_speak_probe --tiny --device cpu
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import signal
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

TONES = "abcdefgh"
SR = 24_000
CHAR_SECONDS = 0.32  # = 30 mel frames exactly (hop 256): no drift against avg-upsample
FRAMES_PER_CHAR = 30


def tone_freq(idx: int) -> float:
    return 220.0 * 2.0 ** (idx * 3.0 / 7.0)  # 220 .. 1751 Hz, log-spaced


def synth_utterance(text: str, rng) -> np.ndarray:
    segs = []
    phase = 0.0
    n_seg = int(CHAR_SECONDS * SR)
    for ch in text:
        f = tone_freq(TONES.index(ch))
        t = np.arange(n_seg) / SR
        seg = 0.42 * np.sin(phase + 2 * np.pi * f * t)
        env = np.minimum(1.0, np.minimum(np.arange(n_seg), n_seg - np.arange(n_seg)) / (0.015 * SR))
        segs.append(seg * env)
        phase += 2 * np.pi * f * n_seg / SR
    wav = np.concatenate(segs)
    return (wav + 0.003 * rng.standard_normal(len(wav))).astype(np.float32)


def make_dataset(out_dir: str, n_files: int, rng, lo=4, hi=10) -> list[dict]:
    """JAX's rows and files.  Every utterance is synthesized, written or
    not, so the generator's draws, and with them every later row's text,
    do not depend on which files a directory already holds (JAX draws the
    noise only for a file it writes)."""
    from f5_tts_tpu_torch.audio.io import save_wav

    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for i in range(n_files):
        n_chars = int(rng.integers(lo, hi + 1))
        text = "".join(TONES[j] for j in rng.integers(0, len(TONES), n_chars))
        path = os.path.join(out_dir, f"tone_{i}.wav")
        wav = synth_utterance(text, rng)
        if not os.path.isfile(path):
            save_wav(path, wav, SR)
        rows.append({"audio_path": path, "text": text, "duration": n_chars * CHAR_SECONDS})
    return rows


def decode_tones(gen_mel: np.ndarray, n_chars: int, freqs: np.ndarray) -> str:
    """Per-character dominant mel bin -> nearest tone character.  gen_mel [frames, d]."""
    out = []
    for k in range(n_chars):
        seg = gen_mel[k * FRAMES_PER_CHAR + 4:(k + 1) * FRAMES_PER_CHAR - 4]
        if not len(seg):
            out.append("?")
            continue
        f = freqs[int(np.argmax(seg.mean(axis=0)))]
        out.append(TONES[int(np.argmin([abs(f - tone_freq(i)) for i in range(len(TONES))]))])
    return "".join(out)


def probe_config(dim: int, depth: int, heads: int):
    """JAX's probe ``ModelConfig``: F5TTS_v1_Base narrowed, byte tokens,
    average upsampling, no activation checkpointing."""
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

    cfg = MODEL_CONFIGS["F5TTS_v1_Base"]
    return dataclasses.replace(
        cfg, tokenizer="byte",
        arch=dataclasses.replace(
            cfg.arch, dim=dim, depth=depth, heads=heads, dim_head=dim // heads,
            text_dim=min(dim, 64), text_num_embeds=256, conv_layers=2,
            text_embedding_average_upsampling=True, checkpoint_activations=False))


def bin_freqs(mel_cfg) -> np.ndarray:
    """The centre frequency of each mel bin (its filter's peak FFT bin)."""
    from f5_tts_tpu_torch.ops.mel import _fbank_np

    fft_freqs = np.linspace(0, mel_cfg.target_sample_rate / 2, mel_cfg.n_fft // 2 + 1)
    return fft_freqs[np.argmax(_fbank_np(mel_cfg), axis=0)]


def held_out(n_eval: int, tiny: bool, mel_cfg) -> dict:
    """JAX's held-out set: a 4-character reference prompt and 6-10 (tiny: 3)
    characters to generate per row, one bucket (512; tiny 256), and the
    arrays the sampler takes (cond, tids, durs, rlens, noise)."""
    from f5_tts_tpu_torch.ops.mel import log_mel_np

    eval_rng = np.random.default_rng(4242)
    bucket = 512 if not tiny else 256
    evals = []
    for _ in range(n_eval):
        ref_text = "".join(TONES[j] for j in eval_rng.integers(0, len(TONES), 4))
        n_gen = int(eval_rng.integers(6, 11)) if not tiny else 3
        gen_text = "".join(TONES[j] for j in eval_rng.integers(0, len(TONES), n_gen))
        ref_wav = synth_utterance(ref_text, eval_rng)
        ref_mel = log_mel_np(ref_wav, mel_cfg)[0]
        evals.append({"ref_text": ref_text, "gen_text": gen_text,
                      "ref_mel": ref_mel, "ref_len": len(ref_mel),
                      "duration": (len(ref_text) + len(gen_text)) * FRAMES_PER_CHAR})
    b = len(evals)
    d = mel_cfg.n_mel_channels
    cond = np.zeros((b, bucket, d), np.float32)
    tids = np.full((b, bucket), -1, np.int32)
    durs = np.zeros((b,), np.int32)
    rlens = np.zeros((b,), np.int32)
    for i, e in enumerate(evals):
        cond[i, :e["ref_len"]] = e["ref_mel"]
        ids = np.frombuffer((e["ref_text"] + e["gen_text"]).encode(), np.uint8)
        tids[i, :len(ids)] = ids
        durs[i] = e["duration"]
        rlens[i] = e["ref_len"]
    noise = np.asarray(np.random.default_rng(7).standard_normal((b, bucket, d)), np.float32)
    return {"evals": evals, "bucket": bucket, "cond": cond, "tids": tids, "durs": durs,
            "rlens": rlens, "noise": noise}


def shuffled_ids(held: dict) -> np.ndarray:
    """The held-out text ids with each row's characters permuted (JAX's seed 99)."""
    tids = held["tids"]
    out = tids.copy()
    rng = np.random.default_rng(99)
    for i, e in enumerate(held["evals"]):
        n_ids = len(e["ref_text"]) + len(e["gen_text"])
        out[i, :n_ids] = tids[i, :n_ids][rng.permutation(n_ids)]
    return out


def cast_backbone(model, dtype):
    """A copy of ``model``'s backbone in ``dtype`` for sampling (the online
    weights stay as they are)."""
    return copy.deepcopy(model.transformer).to(dtype).eval().requires_grad_(False)


def sample_mel(backbone, arch, held: dict, nfe: int, cfg_strength: float, dtype) -> np.ndarray:
    """The CER sampler: ``cfm.sample`` (NFE Euler, sway, fused CFG) on the
    held-out set -> mel [b, bucket, d] fp32."""
    import torch

    from f5_tts_tpu_torch.models import cfm

    dev = next(backbone.parameters()).device

    def t(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    with torch.inference_mode():
        out = cfm.sample(backbone, arch, t(held["cond"], dtype), t(held["tids"]),
                         t(held["durs"]), t(held["noise"], dtype), lens=t(held["rlens"]),
                         opts=cfm.SampleOptions(steps=nfe, cfg_strength=cfg_strength),
                         backend="auto")
    return out.float().cpu().numpy()


def cer_of(mel: np.ndarray, held: dict, freqs: np.ndarray, rows=None) -> tuple:
    """(mean CER, mean tone accuracy, (truth, decoded) pairs) of the
    generated part of each row.  ``rows``: per-row mels instead of ``mel``."""
    from f5_tts_tpu_torch.eval.metrics import word_error_rate

    cers, accs, pairs = [], [], []
    for i, e in enumerate(held["evals"]):
        m = rows[i] if rows is not None else mel[i]
        gen_mel = np.asarray(m[e["ref_len"]:e["duration"]], np.float32)
        hyp = decode_tones(gen_mel, len(e["gen_text"]), freqs)
        cers.append(word_error_rate(e["gen_text"], hyp, lang="zh"))
        accs.append(np.mean([a == b for a, b in zip(hyp, e["gen_text"])]))
        pairs.append((e["gen_text"], hyp))
    return float(np.mean(cers)), float(np.mean(accs)), pairs


def vel_at(backbone, arch, held: dict, ids: np.ndarray, t: float, dtype) -> np.ndarray:
    """The backbone's velocity at time ``t`` with pure noise as its input,
    the held-out prompts as condition and text ``ids`` -> [b, bucket, d] fp32."""
    import torch

    from f5_tts_tpu_torch.models import dit

    dev = next(backbone.parameters()).device
    bucket, durs, rlens = held["bucket"], held["durs"], held["rlens"]
    frames = np.arange(bucket)[None, :]
    with torch.inference_mode():
        te = dit.text_embedding(backbone, arch, torch.as_tensor(ids, device=dev), bucket,
                                lens=torch.as_tensor(durs, device=dev))
        cond = torch.as_tensor(held["cond"], device=dev, dtype=dtype)
        step_cond = torch.where(torch.as_tensor((frames < rlens[:, None])[..., None], device=dev),
                                cond, torch.zeros_like(cond))
        v = dit.forward(backbone, arch, torch.as_tensor(held["noise"], device=dev, dtype=dtype),
                        step_cond, te.to(dtype), torch.full((len(durs),), t, device=dev,
                                                            dtype=dtype),
                        mask=torch.as_tensor(frames < durs[:, None], device=dev), backend="auto")
    return v.float().cpu().numpy()


def order_mse(backbone, arch, held: dict, dtype, t: float = 0.05) -> float:
    """Velocity MSE at low t for the correct against the shuffled text: a
    model that reads the characters' order must answer a permutation
    differently."""
    v_ok = vel_at(backbone, arch, held, held["tids"], t, dtype)
    v_sh = vel_at(backbone, arch, held, shuffled_ids(held), t, dtype)
    return float(np.mean((v_ok - v_sh) ** 2))


def save_params(model, path: str) -> None:
    """The CFM's weights under the reference's key names (``transformer.*``)."""
    from f5_tts_tpu_torch.utils.ckpt import write_checkpoint

    write_checkpoint(path, {k: v.detach().float().cpu() for k, v in model.state_dict().items()})


def load_params(model, path: str):
    from f5_tts_tpu_torch.utils.ckpt import load_dit_state, load_torch_state

    return load_dit_state(model, load_torch_state(path))


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(prog="train_speak_probe")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--files", type=int, default=1024)
    ap.add_argument("--batch-frames", type=int, default=8192)
    ap.add_argument("--nfe", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=2.0)
    ap.add_argument("--max-updates", type=int, default=20_000)
    ap.add_argument("--total-updates", type=int, default=None,
                    help="LR decay horizon (default: --max-updates); pin it to compare runs "
                    "with different stopping points fairly")
    ap.add_argument("--eval-every", type=int, default=1_000)
    ap.add_argument("--target-cer", type=float, default=0.05)
    ap.add_argument("--n-eval", type=int, default=24, help="held-out utterances")
    ap.add_argument("--out", default=os.path.join(tmp, "speak_probe_params.pt"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "speak_probe_ck"))
    ap.add_argument("--data-dir", default=os.path.join(tmp, "speak_tone_ds"))
    ap.add_argument("--skip-train", default=None,
                    help="saved weights (.pt): skip training, run the evals only")
    ap.add_argument("--fresh", action="store_true", help="wipe --ckpt-dir instead of resuming it")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="CI smoke: tiny arch, few updates")
    ap.add_argument("--seed", type=int, default=0,
                    help="trainer seed (data order + per-step randomness stream); the "
                    "order-alignment 'click' update varies strongly by stream")
    args = ap.parse_args(argv)

    import torch

    from f5_tts_tpu_torch.infer.api import _seeded
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine, pick_bucket
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.ops import cuda_build
    from f5_tts_tpu_torch.train.dataset import CustomDataset, DynamicBatchSampler
    from f5_tts_tpu_torch.train.step import OptimConfig
    from f5_tts_tpu_torch.train.trainer import Trainer
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device, "train_speak_probe")
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    if args.tiny:
        args.dim, args.depth, args.heads = 64, 2, 2
        args.files, args.max_updates, args.eval_every = 12, 4, 4
        args.n_eval, args.nfe = 2, 2

    model_cfg = probe_config(args.dim, args.depth, args.heads)
    arch, mel_cfg = model_cfg.arch, model_cfg.mel
    rows = make_dataset(args.data_dir, args.files, np.random.default_rng(0))
    ds = CustomDataset(rows, durations=[r["duration"] for r in rows], mel_cfg=mel_cfg)
    held = held_out(args.n_eval, args.tiny, mel_cfg)
    freqs = bin_freqs(mel_cfg)

    def eval_cer(model):
        return cer_of(sample_mel(cast_backbone(model, dtype), arch, held, args.nfe, args.cfg,
                                 dtype), held, freqs)

    launches = {"eval": Counter()}
    curve = []
    model = _seeded(lambda: CFM(arch), 0)
    if args.skip_train:
        load_params(model, args.skip_train)
        model = model.to(dev)
        print(f"loaded params from {args.skip_train}", file=sys.stderr)
        cer, acc, _ = eval_cer(model)
        curve.append({"update": -1, "cer": round(cer, 4), "tone_acc": round(acc, 4)})
        print(json.dumps(curve[-1]), flush=True)
    else:
        import shutil

        if args.fresh:
            shutil.rmtree(args.ckpt_dir, ignore_errors=True)
        t_start = time.perf_counter()
        t_seg = [t_start]

        # CER evals run inside the training loop through the trainer's
        # log_samples hook (the 3-argument form hands over the online
        # weights); the early stop takes the Trainer's SIGTERM route
        def eval_hook(ema_model, update, online):
            before = cuda_build.launch_counts()
            cer, acc, pairs = eval_cer(online)
            launches["eval"].update(cuda_build.launches_since(before))
            now = time.perf_counter()
            rec = {"update": int(update), "cer": round(cer, 4), "tone_acc": round(acc, 4),
                   "wall_s": round(now - t_start, 1), "seg_s": round(now - t_seg[0], 1)}
            t_seg[0] = now
            curve.append(rec)
            print(json.dumps(rec), flush=True)
            print(f"  e.g. '{pairs[0][0]}' -> '{pairs[0][1]}' | "
                  f"'{pairs[-1][0]}' -> '{pairs[-1][1]}'", file=sys.stderr)
            save_params(online, args.out)
            if cer < args.target_cer and threading.current_thread() is threading.main_thread():
                print(f"target CER {args.target_cer} reached at update {update}; "
                      "stopping via the preemption path", file=sys.stderr)
                os.kill(os.getpid(), signal.SIGTERM)

        tr = Trainer(
            model_cfg, None,
            OptimConfig(mixed_precision=on_card, learning_rate=args.lr,
                        num_warmup_updates=min(500, args.max_updates // 4),
                        total_updates=args.total_updates or args.max_updates),
            ckpt_dir=args.ckpt_dir, batch_size_per_device=args.batch_frames,
            max_samples=64, save_per_updates=args.eval_every,
            keep_last_n_checkpoints=1, last_per_updates=10**9,
            seed=args.seed, mel_in_graph=True, log_samples_fn=eval_hook, device=str(dev),
        )
        per_epoch = len(DynamicBatchSampler(ds, frames_threshold=args.batch_frames,
                                            max_samples=64, random_seed=0))
        epochs = math.ceil(args.max_updates / per_epoch)
        print(f"{per_epoch} updates/epoch; eval every {args.eval_every} updates; "
              f"up to {epochs} epochs", file=sys.stderr)
        before = cuda_build.launch_counts()
        model, _, update = tr.train(model, ds, epochs=epochs, resume=not args.fresh)
        launches["train"] = dict(Counter(cuda_build.launches_since(before)) - launches["eval"])
        launches["train_updates"] = int(update)
        if not curve or curve[-1]["update"] != int(update):
            cer, acc, _ = eval_cer(model)
            curve.append({"update": int(update), "cer": round(cer, 4), "tone_acc": round(acc, 4),
                          "wall_s": round(time.perf_counter() - t_start, 1)})
            print(json.dumps(curve[-1]), flush=True)
        save_params(model, args.out)
        wall = time.perf_counter() - t_start
        launches["train_wall_s"] = wall
        print(f"params saved to {args.out}; {update} updates in {wall:.1f} s", file=sys.stderr)

    backbone = cast_backbone(model, dtype)
    mse = order_mse(backbone, arch, held, dtype)
    print(f"order sensitivity @t=0.05 (correct vs shuffled text): vel MSE {mse:.4f}",
          file=sys.stderr)

    # the serving path: the engine's bucketed graph (replayed on the card)
    # and the Vocos decode; CER again on the engine's mel
    eng = InferenceEngine(copy.deepcopy(model), model_cfg, vocoder=_seeded(Vocos, 1).to(dev),
                          dtype=dtype, options=EngineOptions(nfe_step=args.nfe,
                                                             cfg_strength=args.cfg))
    evals = held["evals"]
    before = cuda_build.launch_counts()
    mels, wavs, _ = eng.generate_batch(
        [e["ref_mel"] for e in evals],
        [np.frombuffer((e["ref_text"] + e["gen_text"]).encode(), np.uint8).astype(np.int32)
         for e in evals],
        [e["duration"] for e in evals], seeds=list(range(len(evals))), fetch_mel=True)
    launches["engine"] = cuda_build.launches_since(before)
    engine_cer, _, _ = cer_of(None, held, freqs, rows=mels)
    assert all(np.isfinite(np.asarray(w)).all() for w in wavs)
    print(f"engine-path CER (engine graph + vocoder, bucket "
          f"{pick_bucket(int(held['durs'].max()))}): {engine_cer:.4f}", file=sys.stderr)

    result = {
        "metric": "speak_probe",
        "cer_curve": curve,
        "final_cer": curve[-1]["cer"] if curve else None,
        "engine_cer": round(engine_cer, 4),
        "order_sensitivity_mse": round(mse, 4),
        "nfe": args.nfe, "cfg_strength": args.cfg,
        "arch": {"dim": args.dim, "depth": args.depth, "heads": args.heads},
        "launches": {**launches, "eval": dict(launches["eval"])},
        "params": args.skip_train or args.out,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
