"""Rank bodies of the port's multi-process tests (``tests/test_torch_parallel*.py``).

Each test spawns ``world`` processes with ``torch.multiprocessing`` (the
``spawn`` method), joined in a gloo group through a file under the test's
``tmp_path`` (no TCP port, so concurrent test workers never collide).  The
parent writes the inputs to ``<tmp>/in.pt``; rank r runs one case function
of this module and writes what it found to ``<tmp>/out<r>.pt``; a failure
in any rank fails the spawn.  Nothing here imports JAX: the parent holds
the results against the JAX package.
"""

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(case: str, world: int, tmp: str, timeout: float = 240.0) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks; returns each rank's outputs."""
    ctx = mp.start_processes(_entry, args=(case, world, str(tmp)), nprocs=world, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=timeout):
        pass
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(world)]


def _entry(rank: int, case: str, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)
    os.environ["RANK"] = str(rank)
    from f5_tts_tpu_torch.parallel.distributed import init_distributed

    topo = init_distributed(f"file://{tmp}/pg", num_processes=world, process_id=rank,
                            device="cpu")
    assert topo["process_count"] == world and topo["backend"] == "gloo", topo
    try:
        inputs = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = globals()[case](rank, world, tmp, inputs)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- ring


def ring(rank, world, tmp, inp):
    """Ring attention's per-shard body over a seq group of 4 (the world)
    and of 2 (a data 2 x seq 2 mesh), both blocks, with and without a mask:
    this rank's o, L and the gradients of a loss that reads o (and, in the
    ``lse`` cases, L too)."""
    from f5_tts_tpu_torch.ops.attention import attention
    from f5_tts_tpu_torch.parallel import ring as R
    from f5_tts_tpu_torch.parallel.sequence import make_sp_mesh

    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.parallel.distributed import process_batch_slice
    from f5_tts_tpu_torch.parallel.sequence import activation_spec

    mesh = make_sp_mesh(data=2, seq=2)
    groups = {4: dist.group.WORLD, 2: mesh.get_group("seq")}
    state = M.shard_opt_state({"m": torch.arange(8.0).reshape(4, 2), "n": torch.zeros(3),
                               "count": torch.zeros(())}, mesh)
    layout = dict(activation=activation_spec(mesh), batch=M.batch_sharding(mesh),
                  rows=process_batch_slice(8, mesh), world_rows=process_batch_slice(8),
                  data=M.data_rank_and_size(mesh), state=state,
                  dims=(M.make_mesh(model=2).mesh_dim_names, M.make_mesh(model=2).shape,
                        M.make_train_mesh(seq=2).mesh_dim_names))
    q, k, v, lens = inp["q"], inp["k"], inp["v"], inp["lens"]
    n = q.shape[2]
    out = {}
    for sp, group in groups.items():
        nl = n // sp
        my, size, shift = R.group_shift(group)
        assert size == sp
        sl = slice(my * nl, (my + 1) * nl)
        for impl in ("xla", "flash"):
            for masked in (True, False):
                qs, ks, vs = (t[:, :, sl].clone().requires_grad_(True) for t in (q, k, v))
                ln = lens if masked else torch.full_like(lens, n)
                o, L = R._ring_local(qs, ks, vs, ln, my=my, sp=sp, shift=shift, block_impl=impl,
                                     return_lse=True)
                w, wl = inp["w"][:, :, sl], inp["wl"][:, :, sl]
                if masked:
                    keep = (torch.arange(n)[sl][None] < ln[:, None]).float()
                    w, wl = w * keep[:, None, :, None], wl * keep[:, None, :]
                for lse in (False, True):
                    loss = (o * w).sum() + ((L * wl).sum() if lse else 0.0)
                    g = torch.autograd.grad(loss, (qs, ks, vs), retain_graph=True)
                    out[(sp, impl, masked, lse)] = dict(
                        o=o.detach(), L=L.detach(), grads=[t.detach() for t in g], my=my)
        # the attention backend itself (a callable), the mask shard in
        mask = torch.arange(n)[None] < lens[:, None]
        backend = R.make_ring_attention_local("auto", group=group)
        o = attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], mask=mask[:, sl], backend=backend)
        out[(sp, "backend")] = dict(o=o, my=my)
    out["layout"] = layout
    return out


# ----------------------------------------------------------- sequence parallel


def _dit(inp):
    from f5_tts_tpu_torch.models.dit import DiT

    model = DiT(inp["cfg"])
    model.load_state_dict(inp["state"])
    return model.eval()


def dit_sp(rank, world, tmp, inp):
    """DiT forward on a data 2 x seq 2 mesh (rows over data, frames over seq,
    ring attention), and one train step of the loss at data 2 x seq 2 and
    at seq 2 alone, through ``train_step``."""
    import copy

    from f5_tts_tpu_torch.models import dit as TD
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.parallel.mesh import data_rank_and_size, mesh_group
    from f5_tts_tpu_torch.parallel.ring import make_ring_attention
    from f5_tts_tpu_torch.parallel.sequence import make_seq_constraint, make_sp_mesh
    from f5_tts_tpu_torch.train.step import OptimConfig, make_optimizer, train_step

    mesh = make_sp_mesh(data=2, seq=2)
    hook, ring = make_seq_constraint(mesh), make_ring_attention(mesh, "auto")
    dr, dp = data_rank_and_size(mesh)
    x, cond, te, time, mask = (inp[k] for k in ("x", "cond", "te", "time", "mask"))
    per = x.shape[0] // dp
    rows = slice(dr * per, (dr + 1) * per)
    model = _dit(inp)
    with torch.no_grad():
        y = TD.forward(model, inp["cfg"], x[rows], cond[rows], te[rows], time[rows],
                       mask=mask[rows], backend=ring, activation_constraint=hook)
    out = {"forward": y, "rows": (rows.start, rows.stop)}

    for name, m in (("dp2_sp2", mesh), ("sp2", None)):
        if m is None:  # seq 2 over ranks {0, 1} and {2, 3}: two data-less seq groups
            sub = [dist.new_group([0, 1]), dist.new_group([2, 3])]
            group = sub[rank // 2]
            from f5_tts_tpu_torch.parallel.ring import make_ring_attention_local
            from f5_tts_tpu_torch.parallel.sequence import SeqShard

            hk, bk = SeqShard(group), make_ring_attention_local("auto", group=group)
            start, b_rows, dgroup, ggroup = 0, inp["mel"].shape[0], None, group
            lo, hi = 0, b_rows
        else:
            hk, bk = hook, ring
            b_rows = inp["mel"].shape[0] // dp
            lo, hi = dr * b_rows, (dr + 1) * b_rows
            start, dgroup, ggroup = lo, mesh.get_group("data"), mesh_group(mesh)
        cfm = CFM(inp["cfg"])
        cfm.transformer.load_state_dict(inp["state"])
        ema = copy.deepcopy(cfm).requires_grad_(False)
        opt_cfg = OptimConfig(num_warmup_updates=0, total_updates=10, learning_rate=1e-4)
        opt = make_optimizer(list(cfm.parameters()), opt_cfg)
        batch = {"mel": inp["mel"][lo:hi], "text_ids": inp["text_ids"][lo:hi],
                 "lens": inp["lens"][lo:hi]}
        grads = {}
        orig = opt.step

        def keep(gs, orig=orig):  # the summed gradients, before the update
            grads.update({k: g.clone() for (k, _), g in zip(cfm.named_parameters(), gs)})
            return orig(gs)

        opt.step = keep
        _, met = train_step(cfm, opt, ema, 0, batch, 7, opt_cfg, backend=bk,
                            activation_constraint=hk, rows=(start, inp["mel"].shape[0]),
                            data_group=dgroup, grad_group=ggroup)
        out[name] = dict(loss=met["loss"].item(), grad_norm=met["grad_norm"].item(),
                         grads=grads, params={k: p.detach().clone()
                                              for k, p in cfm.named_parameters()})
    return out


# ------------------------------------------------------------------- serving


def serve(rank, world, tmp, inp):
    """``BatchServer`` with a data 2 mesh and with a seq 2 mesh, each next to
    ``mesh=None`` on the same seeded engine: wavs and mels of every request,
    each ``run`` over three batches at ``overlap`` 2 (two threads, which
    the seq 2 server must serialise for its ring's collectives), with the
    most engine calls that were in flight at once."""
    import threading
    import time
    from f5_tts_tpu_torch.infer.api import F5TTS
    from f5_tts_tpu_torch.infer.serve import BatchServer, Request
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh
    from f5_tts_tpu_torch.parallel.sequence import make_sp_mesh

    reqs = [Request(**r) for r in inp["requests"]]
    out = {}
    for name, mesh, sp in (("plain", None, False), ("data2", make_train_mesh(data=2), False),
                           ("seq2", make_sp_mesh(data=1, seq=2), True)):
        eng = F5TTS(model="F5TTS_Tiny", init_random=True, device="cpu", nfe_step=2).engine
        srv = BatchServer(eng, mesh=mesh, batch_size=2, sequence_parallel=sp)
        lock, live, call = threading.Lock(), [0, 0], eng.generate_batch

        def counted(*a, lock=lock, live=live, call=call, **k):
            with lock:
                live[0] += 1
                live[1] = max(live[1], live[0])
            time.sleep(0.1)  # the other thread, if any, enters meanwhile
            try:
                return call(*a, **k)
            finally:
                with lock:
                    live[0] -= 1

        eng.generate_batch = counted
        wavs, lats = srv.run(reqs, fetch_mel=True, overlap=2)
        out[name] = dict(in_flight=live[1], wavs=wavs,
                         mels=[srv.mels[i] for i in range(len(reqs))],
                         taps=eng.options.convpos_taps, hooks=eng.parallel_hooks[1] is not None,
                         n_lat=len(lats))
    return out


# ------------------------------------------------------------------- training


def _dataset(inp):
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    return CustomDataset(inp["rows"], preprocessed_mel=True)


def _trainer(inp, ckpt, **kw):
    from f5_tts_tpu_torch.train.trainer import Trainer

    base = dict(batch_size_per_device=3, batch_size_type="sample", save_per_updates=1000,
                last_per_updates=1000, seed=3, device="cpu", log_every_updates=1)
    base.update(kw)
    return Trainer(inp["model_cfg"], None, inp["opt"], ckpt_dir=ckpt, **base)


def _cfm(inp):
    from f5_tts_tpu_torch.models.cfm import CFM

    m = CFM(inp["model_cfg"].arch)
    m.load_state_dict(inp["init"])
    return m


def _params(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def train(rank, world, tmp, inp):
    """At data 2: the Trainer's DP and ZeRO-1 runs, a ZeRO-1 run cut after
    its first epoch (resumed at dp 1 by the parent), the loss gradient with
    injected draws over this rank's padded rows, and the CLI under a world
    of 2 with ``--sequence_parallel 2 --zero1``."""
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh
    from f5_tts_tpu_torch.train.step import all_reduce_sum_

    mesh = make_train_mesh(data=2)
    ds = _dataset(inp)
    out = {}
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.parallel.sequence import make_sp_mesh

    try:  # UNetT takes no activation constraint (JAX fails at its first step)
        _trainer(dict(inp, model_cfg=MODEL_CONFIGS["E2TTS_Base"]), os.path.join(tmp, "unett"),
                 mesh=make_sp_mesh(data=1, seq=2), sequence_parallel=True)
        out["sp_unett"] = None
    except ValueError as e:
        out["sp_unett"] = str(e)
    for name, kw, epochs in (("dp", {}, 2), ("zero1", dict(zero1=True), 2),
                             ("zero1_cut", dict(zero1=True), 1)):
        tr = _trainer(inp, os.path.join(tmp, name), mesh=mesh, **kw)
        model, ema, update = tr.train(_cfm(inp), ds, epochs=epochs, resume=False)
        out[name] = dict(params=_params(model), ema=_params(ema), update=update,
                         state_bytes=tr.optimizer.state_bytes(),
                         zero1=tr.zero1)
        if rank == 0:
            out[name]["log"] = open(tr.log_file).read()

    # the loss over this rank's rows of a padded batch, the draws injected
    from f5_tts_tpu_torch.models import cfm as TC

    g = inp["loss_case"]
    per = g["mel"].shape[0] // 2
    rows = slice(rank * per, (rank + 1) * per)
    model = _cfm(inp)
    inject = {k: (v[rows] if torch.is_tensor(v) else v) for k, v in g["inject"].items()}
    loss = TC.loss(model.transformer, inp["model_cfg"].arch, g["mel"][rows], g["text_ids"][rows],
                   g["lens"][rows], valid=g["valid"][rows], inject=inject, backend="train_auto",
                   count_group=dist.group.WORLD)
    names = [k for k, _ in model.named_parameters()]
    grads = list(torch.autograd.grad(loss, list(model.parameters())))
    all_reduce_sum_(grads, dist.group.WORLD)
    total = loss.detach().clone()
    dist.all_reduce(total)
    out["loss_case"] = dict(loss=total.item(), grads=dict(zip(names, grads)))

    # bench_train under a world of 2: data-parallel steps, rank 0 reports
    from f5_tts_tpu_torch.scripts import bench_train

    out["bench_train"] = bench_train.main(["1", "fp32", "chunked", "none", "32", "1",
                                           "F5TTS_Tiny", "cpu", "1"])

    # the CLI: data from WORLD_SIZE / S, the dataset loader swapped for rows
    from f5_tts_tpu_torch.train import cli as TCLI
    from f5_tts_tpu_torch.train import dataset as TDS

    TDS.load_dataset = lambda *a, **k: TDS.CustomDataset(inp["cli_rows"], preprocessed_mel=True)
    ck = os.path.join(tmp, "cli")
    TCLI.main(["--model", "F5TTS_Tiny", "--device", "cpu", "--epochs", "1", "--ckpt_dir", ck,
               "--batch_size_per_gpu", "400", "--sequence_parallel", "2", "--zero1",
               "++optim.num_warmup_updates=1", "++ckpts.last_per_updates=1"])
    out["cli"] = dict(exists=os.path.exists(os.path.join(ck, "model_last.pt")),
                      log=open(os.path.join(ck, "train_log.jsonl")).read() if rank == 0 else "")
    return out
