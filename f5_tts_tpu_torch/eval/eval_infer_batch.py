"""Batch test-set synthesis (reference src/f5_tts/eval/eval_infer_batch.py).

JAX counterpart: ``f5_tts_tpu/eval/eval_infer_batch.py``.  Synthesizes
seedtts_test_zh / seedtts_test_en / ls_pc_test_clean with the bucketed
``BatchServer``.  Under ``torchrun`` the utterances shard over the ``data``
ranks (``parallel/distributed.init_distributed``, one process per card),
where JAX takes ``len(jax.devices())``; in one process the server runs with
``mesh=None``.  Every rank gets every waveform back from the server, and
only rank 0 writes the files.  The result directory encodes
seed/nfe/vocoder/cfg/speed like the reference (:103-111), and ``rtf.txt``
holds ``serve.rtf_report``'s keys, as JAX's.

Usage:
    python -m f5_tts_tpu_torch.eval.eval_infer_batch -t seedtts_test_en \
        -n F5TTS_v1_Base -p ckpt.safetensors --vocoder_local_path vocos.pt
    (``--device cpu`` for the CPU; ``torchrun --nproc_per_node=N -m ...``
    over N cards)
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="batch inference")
    p.add_argument("-s", "--seed", default=None, type=int)
    p.add_argument("-n", "--expname", default="F5TTS_v1_Base")
    p.add_argument("-c", "--ckptstep", default=1250000, type=int)
    p.add_argument("-p", "--ckpt_file", default="", type=str)
    p.add_argument("--vocoder_local_path", default=None, type=str)
    p.add_argument("-nfe", "--nfestep", default=32, type=int)
    p.add_argument("-o", "--odemethod", default="euler")
    p.add_argument("-ss", "--swaysampling", default=-1.0, type=float)
    p.add_argument("-t", "--testset", required=True,
                   choices=["ls_pc_test_clean", "seedtts_test_zh", "seedtts_test_en"])
    p.add_argument("--librispeech_test_clean_path", default="data/LibriSpeech/test-clean")
    p.add_argument("--metalst_root", default="data")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--results_root", default="results")
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--use_truth_duration", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from f5_tts_tpu_torch.audio.io import save_wav
    from f5_tts_tpu_torch.eval.testsets import (
        get_librispeech_test_clean_metainfo,
        get_seedtts_testset_metainfo,
        prepare_eval_prompts,
    )
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.serve import BatchServer, Request, rtf_report
    from f5_tts_tpu_torch.parallel.distributed import init_distributed
    from f5_tts_tpu_torch.parallel.mesh import make_mesh

    cfg_strength, speed = 2.0, 1.0

    if args.testset == "ls_pc_test_clean":
        metalst = os.path.join(args.metalst_root, "librispeech_pc_test_clean_cross_sentence.lst")
        metainfo = get_librispeech_test_clean_metainfo(metalst, args.librispeech_test_clean_path)
    else:
        lang = args.testset.split("_")[-1]
        metalst = os.path.join(args.metalst_root, "seedtts_testset", lang, "meta.lst")
        metainfo = get_seedtts_testset_metainfo(metalst)

    topo = init_distributed(device=args.device)  # alone unless under torchrun
    n_dev, rank = topo["process_count"], topo["process_index"]
    tts = F5TTS(model=args.expname, ckpt_file=args.ckpt_file,
                vocoder_local_path=args.vocoder_local_path, nfe_step=args.nfestep,
                ode_method=args.odemethod, init_random=args.init_random,
                device=topo["device"])
    out_dir = os.path.join(
        args.results_root,
        f"{args.expname}_{args.ckptstep}", args.testset,
        f"seed{args.seed}_{args.odemethod}_nfe{args.nfestep}_{tts.mel_spec_type}"
        f"_ss{args.swaysampling}_cfg{cfg_strength}_speed{speed}",
    )

    prompts = prepare_eval_prompts(metainfo, tts.engine, tts.vocab, tts.tokenizer,
                                   speed=speed, use_truth_duration=args.use_truth_duration)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(ref_mel=pr.ref_mel, text_ids=pr.text_ids, duration=pr.duration,
                seed=int(args.seed if args.seed is not None else rng.integers(2**31 - 1)))
        for pr in prompts
    ]
    mesh = make_mesh(data=n_dev, model=1) if n_dev > 1 else None
    batch = max(args.batch_size, n_dev)
    server = BatchServer(tts.engine, mesh=mesh, batch_size=batch)
    wavs, lats = server.run(reqs)
    sr = tts.target_sample_rate
    rep = rtf_report(wavs, lats, sr)
    if rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        for pr, wav in zip(prompts, wavs):
            if 0 < pr.ref_rms < 0.1:
                wav = wav * (pr.ref_rms / 0.1)
            save_wav(os.path.join(out_dir, pr.utt + ".wav"), wav, sr)
        with open(os.path.join(out_dir, "rtf.txt"), "w") as f:
            for k, v in rep.items():
                f.write(f"{k}: {v}\n")
        print(out_dir)
        print(rep)
    return out_dir


if __name__ == "__main__":
    main()
