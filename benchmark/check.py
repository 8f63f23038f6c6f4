"""The comparison that decides ``correct``: the program's outputs against the
plain reference (``benchmark/reference``), worked out again from the
benchmark's own inputs and seeded weights.

Serving (``serving_checks``): a sample of the finished requests, drawn from
the seed, with the longest among them.  For each, the reference makes the
log-mel of the reference audio, draws the request's noise as the engine
does (a generator on the device seeded with the request's seed, [n, 100] at
the bucket n the request was served in) and samples the mel in fp32:

- ``mel_err``: over the request's frames (reference and generated), the
  L2 norm of the program's mel minus the reference's over the reference's;
- ``wav_err``: the program's waveform against the reference Vocos decoding
  the program's own generated mel, by the same norm.

Each is the largest over the sample.  ``kinds/offline.py`` adds
``below_precision`` (``program.below_precision``), and training's numbers
are in ``kinds/train.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, weights
from benchmark.reference import model as R


def reference_weights(cfg: dict, seed: int, device, vocoder: bool = True):
    """The reference's own fp32 tensors from the run's seed: (backbone, vocos)."""
    s_model, s_voc, _ = program.seeds(seed)
    W = weights.draw(R.backbone_shapes(cfg), s_model, device)
    V = weights.draw(R.vocos_shapes(cfg["vocoder"]), s_voc, device) if vocoder else None
    return W, V


def reference_prec(device) -> R.Prec:
    """The reference's arithmetic: fp32, with the times in the dtype the
    program runs the model in there (bf16 on the card, fp32 on the CPU)."""
    return R.Prec(time=torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32)


def control_prec(device) -> R.Prec:
    """The control: the reference one step below the program's bf16, every
    matmul operand in fp8 e4m3 and the rest in bf16 (fp32 on the CPU, where
    the program runs in fp32)."""
    low = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return R.Prec(dtype=low, quant="fp8", time=low)


def noise(seed: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, 100), generator=gen, device=device, dtype=torch.float32)


def pick_sample(done: list, seed: int, k: int, key) -> list:
    """``k`` of ``done``, drawn from ``seed``, always with the largest by ``key``."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: key(done[i]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([seed, 5])
    pick = list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False)) if rest else []
    return [done[i] for i in [longest] + pick]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


@torch.no_grad()
def serving_errors(cfg, mix, seed, device, items, entry_lens, control=None):
    """[(mel_err, wav_err)] of ``items``: dicts with the request (``req``:
    ref_wav, text_ids, duration, seed), the bucket ``n`` it was served in,
    the program's ``mel`` [n, 100] and ``wav``.  ``entry_lens(L)``: the
    reference frames the entry takes of an L-sample reference.  With the
    ``control`` "reference" (``benchmark/control.py``) the fp8 reference
    stands in the program's place for the mel, and the bf16 reference Vocos
    for the waveform."""
    W, V = reference_weights(cfg, seed, device)
    out = []
    with R.reference_mode():
        for it in items:
            r, n = it["req"], it["n"]
            wav = torch.as_tensor(r.ref_wav, device=device)[None]
            lens = entry_lens(len(r.ref_wav))
            ref_mel = R.log_mel(wav)[0, :lens]
            ids = torch.as_tensor(r.text_ids, device=device)
            args = (W, cfg, ref_mel, ids, r.duration, n, noise(r.seed, n, device), mix["nfe"],
                    mix["cfg_strength"], mix["sway"])
            mel_r = R.sample(*args, reference_prec(device))
            dur = min(max(max(len(r.text_ids), lens) + 1, int(r.duration)), n)
            mel_p = torch.as_tensor(it["mel"], device=device, dtype=torch.float32)
            if control == "reference":
                mel_p = R.sample(*args, control_prec(device))
            mel_err = rel(mel_p[:dur], mel_r[:dur])
            wav_r = R.vocos(V, mel_p[None, lens:dur]).float().clamp(-1, 1)[0]
            wav_p = torch.as_tensor(it["wav"], device=device, dtype=torch.float32)
            if control == "reference":
                low = R.Prec(dtype=torch.bfloat16)
                wav_p = R.vocos(V, mel_p[None, lens:dur], low).float().clamp(-1, 1)[0]
            m = min(len(wav_p), len(wav_r))
            wav_err = rel(wav_p[:m], wav_r[:m]) if len(wav_p) == len(wav_r) else float("inf")
            out.append((mel_err, wav_err))
    return out


def serving_checks(errors, limits) -> dict:
    if not errors:
        return {}
    return {"mel_err": {"value": max(e[0] for e in errors), "limit": limits["mel_err"]},
            "wav_err": {"value": max(e[1] for e in errors), "limit": limits["wav_err"]}}
