"""The training job on ``train/step.train_step``, fed as the trainer feeds it:
``train/dataset.DynamicBatchSampler`` over a pool of utterances held in host
memory, ``collate_wav_batch`` on a producer thread and the upload to the
card on a second one (the trainer's ``mel_in_graph`` path: the step takes
the log-mel of int16 waveforms on the card).

Set-up builds the state of a run resumed after the mix's ``resume_update``
updates: the model (fp32 master weights, seeded on the card), its EMA (the
same shapes, weights of its own from the seed), the optimizer (clip, AdamW
with empty moments, bf16 mixed precision on the card) with its schedule at
that update, past the configuration's warm-up and the EMA's copy phase, so
that every tenth update decays the EMA.  It then runs the first
``check_steps`` steps through the same call and feed as the window, which
also warms every path, the last of them an EMA update.  It keeps what the
comparison reads: each step's loss, the first gradient as AdamW got it (its
first moment after one step over 1 - beta1), and the change of the
parameters and of the EMA over the steps.  The window then steps until
``--seconds`` and waits for the card.  The traced run profiles
``trace_steps`` more steps after the window.

The comparison (``check``) runs the plain reference through the same
``check_steps`` steps from the same seeded weights and EMA, on the same
rows (which utterances the sampler put in each batch), with the same draws
(the loss's generators seeded as the program's step seeds them), and its
own EMA rule.  Numbers, each the worst over steps or leaves:

- ``loss_gap``: |loss - reference loss| / |reference loss| per step;
- ``grad_gap``: per leaf |norm - reference norm| of the first (clipped)
  gradient, over the larger of the leaf's reference norm and the median
  leaf's;
- ``change_gap``: the same for the parameters' change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam);
- ``ema_gap``: the same for the EMA's change over the steps, every leaf.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import program, traffic, weights
from benchmark.reference import model as R
from benchmark.trace import Trace

TOKEN_BASE = 0xE000  # one private-use character per token id


class PoolData:
    """The dataset interface the sampler and ``wav_batch`` read, over the
    host pool of ``traffic.utterances``."""

    def __init__(self, bank, pool, hop):
        self.bank, self.pool, self.hop = bank, pool, hop

    def __len__(self):
        return len(self.pool)

    def get_frame_len(self, i):
        return self.pool[i].samples / self.hop

    def wav_batch(self, idx):
        return [{"wav": traffic.utterance_wav(self.bank, self.pool[i]).astype(np.float32) / 32767.0,
                 "text": "".join(chr(TOKEN_BASE + int(t)) for t in self.pool[i].text_ids)}
                for i in idx]


def step_seed(seed: int, micro: int) -> int:
    """A micro-step's generator seed (the trainer's rule)."""
    return int(np.random.SeedSequence([seed, micro]).generate_state(1)[0])


def setup(cfg, mix, seed, seconds, trace, device, spans, control=None):
    from f5_tts_tpu_torch.train.dataset import DynamicBatchSampler, collate_wav_batch
    from f5_tts_tpu_torch.train.step import make_optimizer

    cuda = torch.device(device).type == "cuda"
    mcfg, model = program.build_model(cfg, seed, device)
    ema = program.build_ema(model, seed)
    opt_cfg = program.optim_config(cfg, mix["total_updates"], mixed_precision=cuda)
    optimizer = make_optimizer(list(model.parameters()), opt_cfg)
    start = mix["resume_update"] * opt_cfg.grad_accumulation_steps
    program.resume_schedule(optimizer, opt_cfg, mix["resume_update"])
    bank, pool = traffic.utterances(mix, seed)
    data = PoolData(bank, pool, mcfg.mel.hop_length)
    sampler = DynamicBatchSampler(data, frames_threshold=mix["frames_threshold"],
                                  max_samples=mix["max_samples"], random_seed=seed)
    vocab = {chr(TOKEN_BASE + i): i for i in range(cfg["arch"]["text_num_embeds"])}
    stop = threading.Event()
    q1, q2 = queue.Queue(maxsize=4), queue.Queue(maxsize=2)

    def put(q, item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        epoch = 0
        while not stop.is_set():
            sampler.set_epoch(epoch)
            for idx in sampler:
                batch = collate_wav_batch(data.wav_batch(idx), vocab, "char", mcfg.mel)
                if not put(q1, (batch, list(idx))):
                    return
            epoch += 1

    def upload():
        while not stop.is_set():
            try:
                batch, idx = q1.get(timeout=0.1)
            except queue.Empty:
                continue
            t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            if cuda:
                t = {k: v.pin_memory().to(device, non_blocking=True) for k, v in t.items()}
            n = (batch["wav"].shape[1] - mcfg.mel.n_fft) // mcfg.mel.hop_length + 1
            if not put(q2, (t, idx, n, batch["lens"].astype(np.int64))):
                return

    threads = [threading.Thread(target=produce, daemon=True),
               threading.Thread(target=upload, daemon=True)]
    for th in threads:
        th.start()
    st = SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=seconds, trace=trace,
                         device=device, spans=spans, model=model, ema=ema, optimizer=optimizer,
                         opt_cfg=opt_cfg, mcfg=mcfg, q=q2, stop=stop, threads=threads,
                         bank=bank, pool=pool, micro=start, steps=[])
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().clone() for p in model.parameters()]
    e0 = [p.detach().to("cpu", copy=True) for p in ema.parameters()]  # off the card
    st.losses, st.batches = [], []
    for s in range(mix["check_steps"]):
        item = q2.get()
        loss = _step(st, item)
        st.losses.append(float(loss))
        st.batches.append((item[1], item[2], step_seed(seed, st.micro - 1)))
        if s == 0:
            b1 = opt_cfg.betas[0]
            st.grad_norms = {n: _moment_norm(optimizer, p) / (1 - b1)
                             for n, p in zip(names, model.parameters())}
    st.change_norms = {n: float((p.detach() - q).norm())
                       for n, p, q in zip(names, model.parameters(), p0)}
    del p0
    st.ema_change = {n: float((p - q.to(p.device)).norm())
                     for (n, p), q in zip(ema.named_parameters(), e0)}
    del e0
    if cuda:
        torch.cuda.synchronize(device)
    return st


def _moment_norm(optimizer, p) -> float:
    """The norm of AdamW's first moment of ``p`` (0 before any update)."""
    m = optimizer.inner.state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.norm())


def _step(st, item):
    from f5_tts_tpu_torch.train.step import train_step

    batch = item[0]
    st.micro, metrics = train_step(st.model, st.optimizer, st.ema, st.micro, batch,
                                   step_seed(st.seed, st.micro), st.opt_cfg,
                                   mel_cfg=st.mcfg.mel)
    return metrics["loss"]


def window(st, t0):
    cuda = torch.device(st.device).type == "cuda"
    deadline = t0 + st.seconds
    waits = []

    def step():
        tw = time.perf_counter()
        with st.spans.span("input_wait"):
            item = st.q.get()
        waits.append(time.perf_counter() - tw)
        with st.spans.span("train_step"):
            _step(st, item)
        return len(item[1]), item[2], item[3]

    while time.perf_counter() < deadline:
        st.steps.append(step())
    if cuda:
        torch.cuda.synchronize(st.device)
    wall = time.perf_counter() - t0
    frames = sum(int(s[2].sum()) for s in st.steps)
    tr, trace_steps = None, []
    if st.trace:  # a traced slice after the window
        with Trace(st.spans, st.device if cuda else None) as tr:
            trace_steps = [step() for _ in range(st.mix["trace_steps"])]
    ctx = {"steps": st.steps, "wall": wall, "waits": waits[:len(st.steps)],
           "trace_steps": trace_steps}
    return {"attempted": len(st.steps) + len(st.batches), "failed": 0,
            "e2e": {"train_frames_per_s": frames / wall}, "ctx": ctx, "trace": tr}


def release(st):
    """Stop the feed and drop the program's state before the reference runs."""
    st.stop.set()
    for th in st.threads:
        th.join(timeout=10)
    del st.model, st.ema, st.optimizer, st.q
    gc.collect()
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()


def reference_batch(st, idx, n):
    """(mel [b, n, 100], text ids [b, nt], lens [b]) of the utterances ``idx``,
    worked out from their raw audio: each row's log-mel, 1 + L // hop frames,
    zero past them."""
    dev = st.device
    b = len(idx)
    mel = torch.zeros((b, n, 100), device=dev)
    lens = torch.zeros((b,), dtype=torch.int32, device=dev)
    nt = max(len(st.pool[i].text_ids) for i in idx)
    ids = torch.full((b, nt), -1, dtype=torch.int64, device=dev)
    for r, i in enumerate(idx):
        u = st.pool[i]
        wav = torch.as_tensor(traffic.utterance_wav(st.bank, u).astype(np.float32) / 32767.0,
                              device=dev)
        m = min(1 + u.samples // traffic.HOP, n)
        mel[r, :m] = R.log_mel(wav[None])[0, :m]
        lens[r] = m
        ids[r, :len(u.text_ids)] = torch.as_tensor(u.text_ids, device=dev)
    return mel, ids, lens


def reference_steps(st, prec=None, keep_rows=1.0):
    """The reference through the checked steps: (losses, first clipped
    gradient's leaf norms, the leaves' change norms, the EMA leaves' change
    norms).  ``keep_rows`` < 1 plants a fault: only that share of each
    batch's rows counts, the mean taken over them."""
    from benchmark.check import reference_prec, reference_weights

    prec = prec or reference_prec(st.device)
    W, _ = reference_weights(st.cfg, st.seed, st.device, vocoder=False)
    W = {k: v.requires_grad_(True) for k, v in W.items()}
    w0 = {k: v.detach().clone() for k, v in W.items()}
    E = weights.draw(R.backbone_shapes(st.cfg), program.seeds(st.seed)[2], st.device)
    e0 = {k: v.clone() for k, v in E.items()}
    mix, optim, ema = st.mix, st.cfg["optim"], st.cfg["ema"]
    opt = R.AdamW(W, optim["learning_rate"], optim["num_warmup_updates"], mix["total_updates"],
                  optim["max_grad_norm"], start=mix["resume_update"])
    losses, grad_norms = [], None
    with R.reference_mode():
        for s, (idx, n, seed) in enumerate(st.batches):
            mel, ids, lens = reference_batch(st, idx, n)
            draws = R.loss_draws(len(idx), n, lens, seed, st.device)
            if keep_rows < 1.0:
                h = max(1, int(len(idx) * keep_rows))
                mel, ids, lens = mel[:h], ids[:h], lens[:h]
                draws = {k: v[:h] if torch.is_tensor(v) else v for k, v in draws.items()}
            rows = max(1, mix["ref_block_frames"] // n)
            loss, grads = R.loss_and_grads(W, st.cfg, mel, ids, lens, draws, prec, rows)
            losses.append(loss)
            norm = opt.step(grads)
            R.ema_update(E, W, mix["resume_update"] + s + 1, ema["decay"],
                         ema["update_after_step"], ema["update_every"])
            if s == 0:
                f = 1.0 if norm < optim["max_grad_norm"] else optim["max_grad_norm"] / norm
                grad_norms = {k: float(g.norm()) * f for k, g in grads.items()}
            del grads
    change = {k: float((W[k].detach() - w0[k]).norm()) for k in W}
    ema_change = {k: float((E[k] - e0[k]).norm()) for k in E}
    return losses, grad_norms, change, ema_change


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    leaf's reference norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def gaps(prog, ref):
    """The four numbers of the comparison, from (losses, grad norms, change
    norms, EMA change norms) of the program and of the reference."""
    (lp, gp, cp, ep), (lr, gr, cr, er) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    med_g = float(np.median(list(gr.values())))
    kept = [k for k in cr if gr[k] >= 1e-3 * med_g]
    return {"loss_gap": loss_gap, "grad_gap": _leaf_gap(gp, gr, list(gr)),
            "change_gap": _leaf_gap(cp, cr, kept), "ema_gap": _leaf_gap(ep, er, list(er))}


def program_readings(st):
    """What the comparison reads of the program's checked steps."""
    return st.losses, st.grad_norms, st.change_norms, st.ema_change


def check(st, out, limits):
    ref = reference_steps(st)
    g = gaps(program_readings(st), ref)
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()}
