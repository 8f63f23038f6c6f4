"""Finetuning toolkit + Gradio UI (reference src/f5_tts/train/finetune_gradio.py).

The reference packs the full wav-folder -> finetuned-model workflow into one
1.9k-LoC Gradio app.  Here every step is a plain importable function (usable
headless and unit-tested — gradio is optional in this build) and ``build_app``
wires them into tabs:

- project management + per-project settings JSON          (reference :77-189, :611-634)
- vocal ``Slicer`` (silence-based segmentation)           (reference :197-312)
- ``transcribe_all`` wav-dir -> sliced wavs + metadata.csv (reference :636-705)
- metadata -> arrow dataset preparation                    (reference :745-855)
- ``calculate_train`` auto settings                        (reference :860-947)
- ``prune_checkpoint`` to EMA-only release weights         (reference :949-972)
- ``expand_model_embeddings`` for vocab extension          (reference :974-1012)
- vocab check/extend                                       (reference :1014-1127)
- training process start/stop + log tail                   (reference :342-609)
- resource monitor (CPU/RAM + device memory)               (reference :1286-1365)
- test-inference on a project checkpoint                   (reference :1179-1226)

JAX counterpart: ``f5_tts_tpu/train/finetune_gradio.py``.  The port's
departures: ``prune_checkpoint`` reads the port trainer's ``.pt`` files, the
reference's ``.pt`` / ``.safetensors`` and JAX-layout ``.npz`` backbone
snapshots, and raises for an orbax directory, which only the JAX package
reads (export it to a ``.npz`` snapshot there first); the release files are
written by ``utils/ckpt.write_safetensors`` (no ``safetensors`` package on
the card's machine); ``get_device_stats`` reads ``torch.cuda``; the training
subprocess is the port's ``train/finetune_cli.py``; ``infer_test`` takes a
``device``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

# ----------------------------------------------------------------- projects

ROOT = os.getcwd()


def _project_dirs(project: str) -> tuple[str, str]:
    """(data_dir, ckpt_dir) for a project (reference path layout)."""
    name = os.path.basename(project)  # no path traversal (_safe_project_path)
    return os.path.join("data", name), os.path.join("ckpts", name)


def get_list_projects() -> list[str]:
    if not os.path.isdir("data"):
        return []
    out = [d for d in os.listdir("data")
           if os.path.isdir(os.path.join("data", d)) and ("_pinyin" in d or "_char" in d)]
    return sorted(out)


def create_data_project(name: str, tokenizer_type: str = "pinyin") -> str:
    proj = f"{os.path.basename(name)}_{tokenizer_type}"
    data_dir, _ = _project_dirs(proj)
    os.makedirs(os.path.join(data_dir, "dataset"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "wavs"), exist_ok=True)
    return proj


# ----------------------------------------------------------------- settings

DEFAULT_SETTINGS = {
    "exp_name": "F5TTS_v1_Base",
    "learning_rate": 1e-5,
    "batch_size_per_device": 3200,
    "batch_size_type": "frame",
    "max_samples": 64,
    "grad_accumulation_steps": 1,
    "max_grad_norm": 1.0,
    "epochs": 100,
    "num_warmup_updates": 100,
    "save_per_updates": 500,
    "keep_last_n_checkpoints": -1,
    "last_per_updates": 100,
    "finetune": True,
    "file_checkpoint_train": "",
    "tokenizer_type": "pinyin",
    "tokenizer_file": "",
    "mixed_precision": "none",
    "logger": "none",
    "ch_8bit_adam": False,
}


def save_settings(project: str, settings: dict) -> str:
    """Persist per-project training settings (reference :77-129)."""
    _, ckpt_dir = _project_dirs(project)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "setting.json")
    merged = {**DEFAULT_SETTINGS, **settings}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2)
    return path


def load_settings(project: str) -> dict:
    """Load settings with defaults for new keys (reference :130-189)."""
    _, ckpt_dir = _project_dirs(project)
    path = os.path.join(ckpt_dir, "setting.json")
    out = dict(DEFAULT_SETTINGS)
    if os.path.isfile(path):
        with open(path, encoding="utf-8") as f:
            out.update(json.load(f))
    return out


# ------------------------------------------------------------------- slicer


class Slicer:
    """Silence-based vocal slicer (fresh implementation of the behavior of the
    slicer the reference vendors at :197-312): frame RMS below ``threshold``
    dBFS for at least ``min_interval`` ms splits the take; segments shorter
    than ``min_length`` ms merge forward; at most ``max_sil_kept`` ms of
    silence is kept around each cut."""

    def __init__(self, sr: int, threshold: float = -40.0, min_length: int = 2000,
                 min_interval: int = 300, hop_size: int = 20, max_sil_kept: int = 2000):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        self.sr = sr
        self.threshold = 10 ** (threshold / 20.0)
        self.hop = max(int(sr * hop_size / 1000), 1)
        self.win = min(max(int(sr * min_interval / 1000), 4 * self.hop), 8 * self.hop)
        self.min_frames = int(min_length / hop_size)
        self.int_frames = int(min_interval / hop_size)
        self.sil_kept = int(max_sil_kept / hop_size)

    def _rms(self, wav: np.ndarray) -> np.ndarray:
        n = (len(wav) - self.win) // self.hop + 1
        if n <= 0:
            return np.asarray([np.sqrt(np.mean(wav**2) + 1e-12)])
        idx = np.arange(self.win)[None, :] + self.hop * np.arange(n)[:, None]
        return np.sqrt(np.mean(wav[idx] ** 2, axis=1) + 1e-12)

    def slice(self, wav: np.ndarray) -> list[np.ndarray]:
        wav = np.asarray(wav, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        rms = self._rms(wav)
        silent = rms < self.threshold
        if silent.all() or len(rms) <= self.min_frames:
            return [wav]
        # silence runs long enough to cut at
        cuts = []
        start = None
        for i, s in enumerate(silent):
            if s and start is None:
                start = i
            elif not s and start is not None:
                if i - start >= self.int_frames:
                    cuts.append((start, i))
                start = None
        if start is not None and len(silent) - start >= self.int_frames:
            cuts.append((start, len(silent)))
        if not cuts:
            return [wav]
        segs = []
        prev_end_f = 0
        for s, e in cuts:
            cut_f = (s + e) // 2  # cut in the middle of the silence run
            seg_start = max(prev_end_f, s - self.sil_kept)
            seg_end = min(cut_f, s + self.sil_kept)
            if seg_end - prev_end_f > 0:
                segs.append((prev_end_f if not segs else seg_start, seg_end))
            prev_end_f = max(cut_f, e - self.sil_kept)
        segs.append((prev_end_f, len(rms)))
        # merge short segments forward
        merged: list[list[int]] = []
        for s, e in segs:
            if merged and (merged[-1][1] - merged[-1][0]) < self.min_frames:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        if len(merged) > 1 and merged[-1][1] - merged[-1][0] < self.min_frames:
            merged[-2][1] = merged[-1][1]
            merged.pop()
        return [wav[s * self.hop: min(e * self.hop + self.win, len(wav))]
                for s, e in merged if e > s]


# ----------------------------------------------------------- transcription


def transcribe_all(
    project: str,
    audio_dir: str,
    language: str = "english",
    transcribe_fn=None,
    do_slice: bool = True,
    slicer_kwargs: dict | None = None,
    target_sr: int = 24_000,
    progress=None,
) -> str:
    """Walk ``audio_dir``, (optionally) slice each file on silence, transcribe
    every segment with ``transcribe_fn(wav, sr) -> str`` (defaults to the local
    Whisper adapter), write ``wavs/segment_N.wav`` + ``metadata.csv`` into the
    project data dir (reference transcribe_all :636-705).  Returns a summary."""
    from f5_tts_tpu_torch.audio.io import load_wav, resample, save_wav
    from f5_tts_tpu_torch.audio.native_loader import load_wav_mono

    def load_audio(path):
        if path.lower().endswith(".wav"):
            return load_wav(path)
        got = load_wav_mono(path)  # native decoder (flac/mp3/ogg)
        if got is None:
            raise RuntimeError(f"cannot decode {path}")
        return got

    if transcribe_fn is None:
        from f5_tts_tpu_torch.audio.asr import make_whisper_transcriber

        transcribe_fn = make_whisper_transcriber(
            language=None if language == "auto" else language)

    data_dir, _ = _project_dirs(project)
    wav_dir = os.path.join(data_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)

    exts = (".wav", ".flac", ".mp3", ".ogg")
    files = sorted(
        os.path.join(r, f)
        for r, _d, fs in os.walk(audio_dir) for f in fs if f.lower().endswith(exts)
    )
    if not files:
        raise FileNotFoundError(f"no audio files under {audio_dir}")

    rows, num_seg, err = [], 0, 0
    for fi, path in enumerate(files):
        if progress is not None:
            progress(fi / len(files), desc=os.path.basename(path))
        try:
            wav, sr = load_audio(path)
        except Exception as e:  # noqa: BLE001
            print(f"skip unreadable {path}: {e}")
            err += 1
            continue
        if np.ndim(wav) > 1:
            wav = np.mean(wav, axis=0)
        if sr != target_sr:
            wav = resample(np.asarray(wav, np.float32), sr, target_sr)
            sr = target_sr
        segs = Slicer(sr, **(slicer_kwargs or {})).slice(wav) if do_slice else [wav]
        for seg in segs:
            if len(seg) < sr * 0.5:  # drop <0.5 s scraps
                continue
            try:
                text = transcribe_fn(seg, sr).strip()
            except Exception as e:  # noqa: BLE001
                print(f"ASR failed on a segment of {path}: {e}")
                err += 1
                continue
            if not text:
                continue
            name = f"segment_{num_seg}.wav"
            save_wav(os.path.join(wav_dir, name), seg, sr)
            rows.append(f"wavs/{name}|{text}")
            num_seg += 1
    meta = os.path.join(data_dir, "metadata.csv")
    with open(meta, "w", encoding="utf-8-sig") as f:
        f.write("audio_file|text\n")
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return f"transcribed {num_seg} segments from {len(files)} files ({err} errors) -> {meta}"


# --------------------------------------------------------------- checkpoints


def prune_checkpoint(ckpt_path: str, out_path: str, save_ema: bool = True,
                     safetensors: bool = True, exp_name: str = "F5TTS_v1_Base") -> str:
    """Strip a training checkpoint to inference-only weights (reference
    :949-972): keeps the EMA (or online) model weights, drops optimizer/EMA
    bookkeeping.  Accepts the port trainer's and the reference's ``.pt`` /
    ``.safetensors`` files and JAX-layout ``.npz`` backbone snapshots (of
    ``exp_name``'s architecture).  An orbax checkpoint directory (JAX's
    trainer) raises: only the JAX package reads it."""
    import torch

    from f5_tts_tpu_torch.utils import ckpt as CK

    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory (an orbax checkpoint of the JAX trainer), which only "
            "the JAX package reads: save its params (or ema) there as a .npz snapshot (its "
            "utils/ckpt.save_pytree) and prune that .npz here")
    if ckpt_path.endswith(".npz"):
        from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS

        state = {f"transformer.{k}": v for k, v in
                 CK.backbone_state_from_npz(ckpt_path, MODEL_CONFIGS[exp_name].arch).items()}
    else:
        state = CK.load_torch_state(ckpt_path, use_ema=save_ema)
    flat = {f"ema_model.{k}" if save_ema else k: torch.as_tensor(v) for k, v in state.items()}
    if safetensors:
        CK.write_safetensors(flat, out_path)
    else:
        torch.save({"ema_model_state_dict" if save_ema else "model_state_dict": flat}, out_path)
    return f"pruned -> {out_path} ({len(flat)} tensors)"


def expand_model_embeddings(ckpt_path: str, new_ckpt_path: str,
                            num_new_tokens: int = 42, seed: int = 0) -> int:
    """Grow the text-embedding table for an extended vocab (reference
    :974-1012); new rows init ~N(0, 0.02) like the reference."""
    from f5_tts_tpu_torch.utils.ckpt import load_torch_state

    state = dict(load_torch_state(ckpt_path, use_ema=True))
    key = next(k for k in state if k.endswith("text_embed.text_embed.weight"))
    old = state[key].numpy()
    rng = np.random.default_rng(seed)
    new = np.concatenate(
        [old, (rng.standard_normal((num_new_tokens, old.shape[1])) * 0.02).astype(old.dtype)]
    )
    state[key] = new
    import torch

    from f5_tts_tpu_torch.utils.ckpt import write_safetensors

    write_safetensors({f"ema_model.{k}": torch.as_tensor(np.asarray(v))
                       for k, v in state.items()}, new_ckpt_path)
    return new.shape[0]


def get_checkpoints_project(project: str) -> list[str]:
    _, ckpt_dir = _project_dirs(project)
    if not os.path.isdir(ckpt_dir):
        return []
    out = [os.path.join(ckpt_dir, d) for d in sorted(os.listdir(ckpt_dir))
           if d.startswith("model_") or d.endswith((".pt", ".safetensors"))]
    return out


# ------------------------------------------------------- training lifecycle

_train_process: subprocess.Popen | None = None


def launch_finetune(args_list: list[str]) -> subprocess.Popen:
    """Spawn the finetune CLI as a subprocess (reference spawns accelerate,
    :342-470)."""
    global _train_process
    cmd = [sys.executable, "-m", "f5_tts_tpu_torch.train.finetune_cli"] + args_list
    _train_process = subprocess.Popen(cmd)
    return _train_process


def start_training(project: str, settings: dict | None = None) -> str:
    """Build the finetune CLI invocation from saved settings and launch it
    (reference start_training :342-470)."""
    cfg = load_settings(project)
    if settings:
        cfg.update(settings)
        save_settings(project, cfg)
    dataset = project.rsplit("_", 1)[0] if project.endswith(("_pinyin", "_char")) else project
    argv = [
        "--exp_name", cfg["exp_name"],
        "--dataset_name", dataset,
        "--learning_rate", str(cfg["learning_rate"]),
        "--batch_size_per_gpu", str(cfg["batch_size_per_device"]),
        "--batch_size_type", cfg["batch_size_type"],
        "--max_samples", str(cfg["max_samples"]),
        "--grad_accumulation_steps", str(cfg["grad_accumulation_steps"]),
        "--epochs", str(cfg["epochs"]),
        "--num_warmup_updates", str(cfg["num_warmup_updates"]),
        "--save_per_updates", str(cfg["save_per_updates"]),
        "--keep_last_n_checkpoints", str(cfg["keep_last_n_checkpoints"]),
        "--last_per_updates", str(cfg["last_per_updates"]),
        "--tokenizer", cfg["tokenizer_type"],
    ]
    if cfg.get("finetune") and cfg.get("file_checkpoint_train"):
        argv += ["--pretrain", cfg["file_checkpoint_train"]]
    launch_finetune(argv)
    return f"training launched (pid {_train_process.pid}); tail the log in the Train tab"


def stop_training() -> str:
    """Terminate the spawned training run (reference :600-609)."""
    global _train_process
    if _train_process is None or _train_process.poll() is not None:
        return "no training process running"
    _train_process.terminate()
    try:
        _train_process.wait(timeout=10)
    except subprocess.TimeoutExpired:
        _train_process.kill()
    return "training stopped"


def tail_train_log(project: str, n: int = 20) -> str:
    """Last n JSONL metric lines of the project's training log."""
    dataset = project.rsplit("_", 1)[0] if project.endswith(("_pinyin", "_char")) else project
    for cand in (os.path.join("ckpts", dataset, "train_log.jsonl"),
                 os.path.join("ckpts", project, "train_log.jsonl")):
        if os.path.isfile(cand):
            with open(cand, encoding="utf-8") as f:
                return "".join(f.readlines()[-n:])
    return "(no training log yet)"


# ------------------------------------------------------------------ monitor


def get_cpu_stats() -> dict:
    """CPU/RAM usage (reference get_cpu_stats :1340-1358)."""
    import psutil

    mem = psutil.virtual_memory()
    return {
        "cpu_percent": psutil.cpu_percent(interval=None),
        "ram_used_gb": round(mem.used / 2**30, 2),
        "ram_total_gb": round(mem.total / 2**30, 2),
        "ram_percent": mem.percent,
    }


def get_device_stats() -> list[dict]:
    """Card memory stats via ``torch.cuda`` (the reference's nvidia-smi
    analog, :1286-1338; JAX reads ``jax.local_devices()``): this process's
    allocator in use and at peak, and the card's total; empty on CPU-only
    hosts."""
    import torch

    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "platform": "gpu",
            "bytes_in_use_gb": round(torch.cuda.memory_allocated(i) / 2**30, 3),
            "bytes_limit_gb": round(torch.cuda.get_device_properties(i).total_memory / 2**30, 3),
            "peak_bytes_gb": round(torch.cuda.max_memory_allocated(i) / 2**30, 3),
        })
    return out


def get_combined_stats() -> str:
    """Human-readable monitor block (reference get_combined_stats :1360-1365)."""
    lines = []
    for d in get_device_stats():
        lines.append(
            f"{d['device']}: {d.get('bytes_in_use_gb', '?')} / "
            f"{d.get('bytes_limit_gb', '?')} GB (peak {d.get('peak_bytes_gb', '?')})")
    c = get_cpu_stats()
    lines.append(f"CPU {c['cpu_percent']}%  RAM {c['ram_used_gb']}/{c['ram_total_gb']} GB "
                 f"({c['ram_percent']}%)")
    return "\n".join(lines)


# ------------------------------------------------------------ data sampling


def get_random_sample_transcribe(project: str, seed: int | None = None):
    """(text, wav_path) of a random metadata row (reference :1141-1168)."""
    data_dir, _ = _project_dirs(project)
    meta = os.path.join(data_dir, "metadata.csv")
    if not os.path.isfile(meta):
        return "", None
    with open(meta, encoding="utf-8-sig") as f:
        rows = [ln.strip() for ln in f.readlines()[1:] if "|" in ln]
    if not rows:
        return "", None
    rng = np.random.default_rng(seed)
    path, text = rows[int(rng.integers(0, len(rows)))].split("|", 1)
    return text, os.path.join(data_dir, path)


# ----------------------------------------------------------------- training


def calculate_train(total_hours: float, frames_per_batch: int = 3200, hop: int = 256,
                    sample_rate: int = 24_000, epochs_target: int = 100):
    """Suggested training settings from dataset size (reference :860-947)."""
    total_frames = total_hours * 3600 * sample_rate / hop
    updates_per_epoch = max(int(total_frames / frames_per_batch), 1)
    total_updates = updates_per_epoch * epochs_target
    warmup = max(int(total_updates * 0.02), 100)
    save_per = max(total_updates // 10 // 100 * 100, 100)
    return {
        "updates_per_epoch": updates_per_epoch,
        "total_updates": total_updates,
        "num_warmup_updates": warmup,
        "save_per_updates": save_per,
        "last_per_updates": max(save_per // 10, 50),
        "learning_rate": 1e-5,
    }


def vocab_count(text: str) -> list[str]:
    return sorted({c for c in text if c != " "})


def vocab_check(metadata_csv: str, vocab_path: str | None = None):
    """Report characters in the dataset missing from the vocab (reference :1081-1127)."""
    from f5_tts_tpu_torch.text.tokenizer import load_vocab

    vocab = load_vocab(vocab_path)
    miss = set()
    with open(metadata_csv, encoding="utf-8-sig") as f:
        next(f, None)
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) >= 2:
                for ch in parts[1]:
                    if ch not in vocab and ch != " ":
                        miss.add(ch)
    return sorted(miss)


def expand_vocab(vocab_path: str, new_tokens: list[str], out_path: str):
    """Append new tokens to a vocab file (embedding rows are expanded at load
    by zero-initializing the new ids, see expand_model_embeddings)."""
    with open(vocab_path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    lines.extend(t for t in new_tokens if t not in set(lines))
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


# --------------------------------------------------------------- test infer


def infer_test(ckpt_file: str, ref_audio: str, ref_text: str, gen_text: str,
               exp_name: str = "F5TTS_v1_Base", vocab_file: str = "",
               nfe_step: int = 32, speed: float = 1.0, seed: int | None = None,
               out_path: str | None = None, vocoder_local_path: str | None = None,
               random_vocoder: bool = False, device: str | None = None):
    """Test-inference on a (pruned) project checkpoint (reference infer
    :1179-1226).  Returns (wav, sr) and optionally writes a wav file.
    ``random_vocoder`` smoke-tests without Vocos weights (noise-like audio);
    ``device``: the card unless the caller names the CPU."""
    from f5_tts_tpu_torch.infer.api import F5TTS

    tts = F5TTS(model=exp_name, ckpt_file=ckpt_file, vocab_file=vocab_file or "",
                nfe_step=nfe_step, vocoder_local_path=vocoder_local_path,
                init_random=random_vocoder, device=device)
    wav, sr, _ = tts.infer(ref_file=ref_audio, ref_text=ref_text, gen_text=gen_text,
                           speed=speed, seed=seed, file_wave=out_path)
    return wav, sr


# --------------------------------------------------------------------- app


def build_app():
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed; `pip install gradio`") from e

    from f5_tts_tpu_torch.train.datasets.prepare_csv_wavs import prepare

    with gr.Blocks(title="F5-TTS finetune (PyTorch)") as app:
        gr.Markdown("# F5-TTS finetuning (PyTorch build)")
        with gr.Tab("Project"):
            new_name = gr.Textbox(label="New project name", value="my_speak")
            tok = gr.Radio(["pinyin", "char"], value="pinyin", label="Tokenizer")
            projects = gr.Dropdown(get_list_projects(), label="Projects", allow_custom_value=True)
            gr.Button("Create").click(
                lambda n, t: gr.update(choices=get_list_projects(), value=create_data_project(n, t)),
                [new_name, tok], [projects])
        with gr.Tab("Transcribe"):
            adir = gr.Textbox(label="Audio folder (wav/flac/mp3)")
            lang = gr.Textbox(label="Language", value="english")
            do_slice = gr.Checkbox(label="Slice on silence", value=True)
            t_log = gr.Textbox(label="Log")
            gr.Button("Transcribe all").click(
                lambda p, a, l, s: transcribe_all(p, a, l, do_slice=s),
                [projects, adir, lang, do_slice], [t_log])
            s_text = gr.Textbox(label="Random sample text")
            s_audio = gr.Audio(label="Random sample audio", type="filepath")
            gr.Button("Random sample").click(
                lambda p: get_random_sample_transcribe(p), [projects], [s_text, s_audio])
        with gr.Tab("Vocab check"):
            vc_out = gr.Textbox(label="Missing characters")
            gr.Button("Check").click(
                lambda p: " ".join(vocab_check(os.path.join(_project_dirs(p)[0], "metadata.csv"))),
                [projects], [vc_out])
        with gr.Tab("Prepare data"):
            prep_log = gr.Textbox(label="Log")

            def do_prepare(project):
                data_dir, _ = _project_dirs(project)
                prepare(os.path.join(data_dir, "metadata.csv"), data_dir,
                        pretrain=project.endswith("_pinyin"),
                        pinyin=project.endswith("_pinyin"))
                return f"prepared -> {data_dir}"

            gr.Button("Prepare").click(do_prepare, [projects], [prep_log])
        with gr.Tab("Train"):
            exp = gr.Dropdown(["F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base"],
                              value="F5TTS_v1_Base", label="Model")
            pretrain_path = gr.Textbox(label="Pretrained ckpt path")
            hours = gr.Number(label="Dataset hours", value=1.0)
            suggest = gr.JSON(label="Suggested settings")
            gr.Button("Suggest settings").click(lambda h: calculate_train(float(h)),
                                                [hours], [suggest])
            train_log = gr.Textbox(label="Status")
            log_tail = gr.Textbox(label="Training log", lines=12)
            gr.Button("Start training").click(
                lambda p, e, pre: start_training(
                    p, {"exp_name": e, "file_checkpoint_train": pre, "finetune": bool(pre)}),
                [projects, exp, pretrain_path], [train_log])
            gr.Button("Stop").click(lambda: stop_training(), [], [train_log])
            gr.Button("Refresh log").click(lambda p: tail_train_log(p), [projects], [log_tail])
        with gr.Tab("Prune / export"):
            in_ckpt = gr.Textbox(label="Checkpoint (.pt/.safetensors/.npz)")
            out_ckpt = gr.Textbox(label="Output path (.safetensors)")
            pr_log = gr.Textbox(label="Log")
            gr.Button("Prune to EMA-only").click(
                lambda i, o: prune_checkpoint(i, o), [in_ckpt, out_ckpt], [pr_log])
        with gr.Tab("Test inference"):
            ckpts = gr.Dropdown([], label="Checkpoint", allow_custom_value=True)
            gr.Button("List checkpoints").click(
                lambda p: gr.update(choices=get_checkpoints_project(p)), [projects], [ckpts])
            ref_a = gr.Audio(label="Reference audio", type="filepath")
            ref_t = gr.Textbox(label="Reference text")
            gen_t = gr.Textbox(label="Text to generate")
            out_a = gr.Audio(label="Generated")

            def do_infer(ck, ra, rt, gt, e):
                wav, sr = infer_test(ck, ra, rt, gt, exp_name=e)
                return (sr, wav)

            gr.Button("Generate").click(do_infer, [ckpts, ref_a, ref_t, gen_t, exp],
                                        [out_a])
        with gr.Tab("Monitor"):
            stats = gr.Textbox(label="System", lines=6)
            gr.Button("Refresh").click(lambda: get_combined_stats(), [], [stats])
    return app


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="f5-tts_finetune-gradio")
    p.add_argument("--port", type=int, default=7861)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)
    build_app().queue().launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
