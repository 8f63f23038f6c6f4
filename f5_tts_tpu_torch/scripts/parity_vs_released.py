"""Parity check of the port against RELEASED checkpoints (run when weights
are available).

JAX counterpart: ``scripts/parity_vs_released.py``, which holds the JAX
package to the repo's torch oracle; this script holds the port to the same
oracle (``tests/oracles/torch_dit.py``, found as JAX's script finds it:
the repo root on ``sys.path``), with a released checkpoint loaded into
both:

  1. the checkpoint's state dict loads into the port's DiT, and its JAX
     layout (``utils/ckpt.jax_params_from_state``, numpy) feeds the oracle;
  2. one fused-CFG guided-velocity step (the NFE loop body, reference
     backbones/dit.py:337-346) runs in the port and in the oracle on
     identical inputs;
  3. a short NFE-4 sample runs through the port's ``cfm.sample`` and the
     oracle's step loop (a copy of ``tests/test_cfm.py``'s
     ``torch_sample_oracle``, which imports JAX where it lives) with
     injected noise (reference cfm.py:83-229);
  4. optional: a Vocos decode of the sampled mel when --vocoder_local_path
     is given.

The oracle's ``forward`` unstacks the blocks with ``jax.tree.map``; the
script runs the oracle's layers in the same order with a numpy unstack, so
it imports no JAX.  The port runs in fp32 on ``--device`` (the card unless
``cpu`` is asked for), the oracle on the CPU.

Usage:
  python -m f5_tts_tpu_torch.scripts.parity_vs_released \
      --ckpt_file model_1250000.safetensors [--model F5TTS_v1_Base] \
      [--vocab_file vocab.txt] [--vocoder_local_path vocos.pt] [--seq_len 256]

Exit code 0 iff every MAE is under its threshold (mel-domain gate 1e-2 per
BASELINE.md).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _oracle():
    """The repo's torch oracle modules (DiT, layers)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tests.oracles import torch_dit as OD
    from tests.oracles import torch_layers as O

    return OD, O


def oracle_forward(p, cfg, x, cond, text_ids, time, mask=None, drop_audio_cond=False,
                   drop_text=False, lens=None):
    """``tests/oracles/torch_dit.forward`` with the blocks unstacked by numpy."""
    OD, O = _oracle()
    b, n, _ = x.shape
    if time.ndim == 0:
        time = time.repeat(b)
    t_emb = O.timestep_embed(p["time_embed"], time)
    te = OD.text_embedding(p, cfg, text_ids, n, lens=lens, drop_text=drop_text)
    h = OD.input_embedding(p, x, cond, te, drop_audio_cond=drop_audio_cond, mask=mask)
    rope = O.rotary_freqs(n, cfg.dim_head)
    for i in range(cfg.depth):
        bp = _take(p["blocks"], i)
        h = O.dit_block(bp, h, t_emb, cfg.heads, mask=mask, rope_freqs=rope,
                        pe_attn_head=cfg.pe_attn_head)
    if "long_skip" in p:
        raise NotImplementedError
    h = O.adaln_final(p["norm_out"], h, t_emb)
    return O.linear(p["proj_out"], h)


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def oracle_sample(params, cfg, cond, text_ids, duration, noise, lens, steps, cfg_strength,
                  sway):
    """The oracle's CFM.sample: padding, masks and the Euler loop
    (``tests/test_cfm.py`` ``torch_sample_oracle``)."""
    import torch

    from f5_tts_tpu_torch.models.cfm import timestep_schedule

    b, n, d = cond.shape
    cond_mask = torch.arange(n)[None, :] < lens[:, None]
    step_cond = torch.where(cond_mask.unsqueeze(-1), cond, torch.zeros_like(cond))
    text_len = (text_ids != -1).sum(dim=-1)
    duration = torch.maximum(torch.maximum(text_len, lens) + 1, duration).clamp(max=n)
    mask = torch.arange(n)[None, :] < duration[:, None]
    y = torch.where(mask.unsqueeze(-1), noise, torch.zeros_like(noise))
    ts = timestep_schedule(steps, sway_sampling_coef=sway, use_epss=True)
    for k in range(steps):
        t = torch.full((b,), float(ts[k]))
        pred = oracle_forward(params, cfg, y, step_cond, text_ids, t, mask=mask, lens=duration)
        null = oracle_forward(params, cfg, y, step_cond, text_ids, t, mask=mask, lens=duration,
                              drop_audio_cond=True, drop_text=True)
        v = pred + (pred - null) * cfg_strength
        y = y + (float(ts[k + 1]) - float(ts[k])) * v
    out = torch.where(cond_mask.unsqueeze(-1), cond, y)
    return torch.where(mask.unsqueeze(-1), out, torch.zeros_like(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="parity_vs_released")
    p.add_argument("--ckpt_file", required=True)
    p.add_argument("--model", default="F5TTS_v1_Base")
    p.add_argument("--model_cfg", default=None,
                   help="JSON arch dict overriding --model (custom checkpoints)")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--vocoder_local_path", default=None)
    p.add_argument("--seq_len", type=int, default=256)
    p.add_argument("--text_len", type=int, default=48)
    p.add_argument("--nfe", type=int, default=4)
    p.add_argument("--use_ema", action="store_true", default=True)
    p.add_argument("--threshold", type=float, default=1e-2)
    p.add_argument("--device", default=None, help="the port's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from f5_tts_tpu_torch.models import cfm as C
    from f5_tts_tpu_torch.models.backbones import get_backbone
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS, from_yaml_dict, with_vocab_size
    from f5_tts_tpu_torch.text.tokenizer import get_tokenizer
    from f5_tts_tpu_torch.utils import ckpt as ckpt_util
    from f5_tts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device, "parity_vs_released")
    if args.model_cfg:
        import json

        arch_kw = json.loads(args.model_cfg)
        model_cfg = from_yaml_dict({"name": args.model,
                                    "backbone": arch_kw.pop("backbone", "DiT"), "arch": arch_kw})
    else:
        model_cfg = MODEL_CONFIGS[args.model]
    _, vocab_size = get_tokenizer(args.vocab_file or None, model_cfg.tokenizer)
    model_cfg = with_vocab_size(model_cfg, vocab_size)
    cfg = model_cfg.arch
    if cfg.backbone != "DiT":
        raise ValueError("the torch oracle is a DiT; parity of other backbones is not covered")

    print(f"loading {args.ckpt_file} (use_ema={args.use_ema}) ...")
    state = ckpt_util.load_torch_state(args.ckpt_file, use_ema=args.use_ema)
    model = C.CFM(cfg)
    ckpt_util.load_dit_state(model, state)
    bb = model.transformer.to(dev).eval()
    params = ckpt_util.jax_params_from_state(model.state_dict(), cfg)
    back = get_backbone(cfg)

    rng = np.random.default_rng(5)
    b, n, nt = 1, args.seq_len, args.text_len
    x = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    cond = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    text = rng.integers(0, cfg.text_num_embeds, (b, nt)).astype(np.int32)
    time = np.array([0.4], dtype=np.float32)
    lens = np.array([n - 30], dtype=np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]

    def on(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    failures = []

    # --- 1 step of fused-CFG guided velocity -------------------------------
    with torch.inference_mode():
        te_c = back.text_embedding(bb, cfg, on(text), n, lens=on(lens))
        te_u = back.text_embedding(bb, cfg, on(text), n, lens=on(lens), drop_text=True)
        pred, null = back.forward_cfg(bb, cfg, on(x), on(cond), te_c, te_u, on(time),
                                      mask=on(mask))
        v_port = (pred + (pred - null) * 2.0).float().cpu().numpy()

    tx, tc = torch.from_numpy(x), torch.from_numpy(cond)
    tt, ttime = torch.from_numpy(text).long(), torch.from_numpy(time)
    tmask, tlens = torch.from_numpy(mask), torch.from_numpy(lens).long()
    with torch.no_grad():
        p_t = oracle_forward(params, cfg, tx, tc, tt, ttime, mask=tmask, lens=tlens)
        u_t = oracle_forward(params, cfg, tx, torch.zeros_like(tc), tt, ttime, mask=tmask,
                             lens=tlens, drop_audio_cond=True, drop_text=True)
    v_oracle = (p_t + (p_t - u_t) * 2.0).numpy()
    mae = np.abs(v_port - v_oracle).mean()
    print(f"CFG ODE-step velocity MAE: {mae:.3e} (threshold {args.threshold})")
    if not mae < args.threshold:
        failures.append(f"ode_step mae {mae:.3e}")

    # --- NFE-k sample ------------------------------------------------------
    noise = rng.standard_normal((b, n, cfg.mel_dim)).astype(np.float32)
    duration = np.array([n - 8], dtype=np.int32)
    cond_s = cond.copy()
    cond_s[0, int(lens[0]):] = 0.0
    opts = C.SampleOptions(steps=args.nfe, cfg_strength=2.0, sway_sampling_coef=-1.0)
    got = C.sample(bb, cfg, on(cond_s), on(text), on(duration), on(noise), lens=on(lens),
                   opts=opts).float().cpu().numpy()
    with torch.no_grad():
        want = oracle_sample(
            params, cfg, torch.from_numpy(cond_s), torch.from_numpy(text).long(),
            torch.from_numpy(duration).long(), torch.from_numpy(noise),
            torch.from_numpy(lens).long(), steps=args.nfe, cfg_strength=2.0, sway=-1.0,
        ).numpy()
    mae_s = np.abs(got - want).mean()
    print(f"NFE-{args.nfe} sampled-mel MAE: {mae_s:.3e} (threshold {args.threshold})")
    if not mae_s < args.threshold:
        failures.append(f"sample mae {mae_s:.3e}")

    # --- Vocoder -----------------------------------------------------------
    if args.vocoder_local_path:
        from f5_tts_tpu_torch.models import vocos as V

        voc = V.Vocos()
        ckpt_util.load_into(voc, ckpt_util.load_torch_state(args.vocoder_local_path,
                                                            use_ema=False))
        with torch.inference_mode():
            wav = V.decode(voc.to(dev).eval(), on(got[..., : model_cfg.mel.n_mel_channels]))
        wav = wav.float().cpu().numpy()
        print(f"vocos decode ok: wav shape {wav.shape}, rms {np.sqrt(np.mean(wav ** 2)):.4f} "
              f"(decode parity with JAX's Vocos: tests/test_torch_cfm_vocos.py)")

    if failures:
        print("PARITY FAIL:", "; ".join(failures))
        return 1
    print("PARITY OK: the checkpoint in the port matches the torch oracle within "
          f"{args.threshold} mel MAE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
