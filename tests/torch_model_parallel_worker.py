"""Rank bodies of the port's tests of parallelism over the model
(``tests/test_torch_tp.py``, ``test_torch_pipeline.py``,
``test_torch_model_parallel_train.py``), spawned as gloo ranks by
``torch_parallel_worker.spawn(..., module="torch_model_parallel_worker")``.
Each case reads the parent's inputs and returns what its rank found; no
JAX here.
"""

import os
import shutil

import torch
import torch.distributed as dist


def _backbone(case):
    from f5_tts_tpu_torch.models.backbones import build_backbone

    model = build_backbone(case["cfg"])
    model.load_state_dict(case["state"])
    return model.eval()


def _forward(case, model, **hooks):
    from f5_tts_tpu_torch.models.backbones import get_backbone

    bb = get_backbone(case["cfg"])
    return bb.forward_with_text(model, case["cfg"], *case["args"], **case["kw"], **hooks)


def _grads(model, y, w) -> dict:
    """{name: gradient} of sum(y * w) over the parameters that got one."""
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad and p.numel()]
    gs = torch.autograd.grad((y * w).sum(), [p for _, p in named], allow_unused=True)
    return {k: g for (k, _), g in zip(named, gs) if g is not None}


def _engine(inp, **opts):
    from f5_tts_tpu_torch.infer.engine import EngineOptions, InferenceEngine
    from f5_tts_tpu_torch.models.cfm import CFM
    from f5_tts_tpu_torch.models.vocos import Vocos

    cfm = CFM(inp["model_cfg"].arch)
    cfm.load_state_dict(inp["cfm_state"])
    voc = Vocos()
    voc.load_state_dict(inp["vocos_state"])
    return InferenceEngine(cfm, inp["model_cfg"], vocoder=voc, buckets=(64, 128),
                           options=EngineOptions(**opts))


def _requests(inp):
    from f5_tts_tpu_torch.infer.serve import Request

    return [Request(**r) for r in inp["requests"]]


def _gen(eng, inp):
    r = inp["gen"]
    return eng.generate_batch(r["refs"], r["texts"], r["durations"], seeds=r["seeds"])[:2]


# ------------------------------------------------------------ tensor parallel


def tp(rank, world, tmp, inp):
    """Tensor-parallel forwards of DiT (also with ``pe_attn_head=1``), UNetT
    and MMDiT at tp 4 and 2, the DiT loss gradients at tp 2,
    ``BatchServer(tensor_parallel=True)`` dense and W8A8 at data 2 x model 2
    against ``mesh=None``, and Picard over a mesh: ``cfm.sample`` at data 2
    and 4 (with and without the AdaLN tables), through the engine, composed
    with tensor parallelism, and the refusal of a window that does not
    divide."""
    from f5_tts_tpu_torch.infer.serve import BatchServer
    from f5_tts_tpu_torch.models import cfm as TC
    from f5_tts_tpu_torch.parallel.mesh import make_mesh, shard_params

    meshes = {4: make_mesh(data=1, model=4), 2: make_mesh(data=2, model=2)}
    data4 = make_mesh(data=4)
    out = {}
    for name, case in inp["backbones"].items():
        for size, mesh in meshes.items():
            model = shard_params(_backbone(case), mesh)
            with torch.no_grad():
                out[(name, size)] = _forward(case, model)
    case = inp["backbones"]["dit"]
    model = shard_params(_backbone(case), meshes[2])
    out["grads"] = _grads(model, _forward(case, model, backend="train_auto"), inp["w"])

    reqs = _requests(inp)
    for name, q in (("dense", False), ("w8a8", True)):
        # mesh=None at batch 1: the rows per engine call of a data rank's at batch 2
        for key, mesh, tp_, b in (("plain", None, False, 1), ("tp", meshes[2], True, 2)):
            srv = BatchServer(_engine(inp, nfe_step=2, quantize=q), mesh=mesh, batch_size=b,
                              tensor_parallel=tp_)
            wavs, _ = srv.run(reqs, fetch_mel=True)
            out[(name, key)] = dict(wavs=wavs, mels=[srv.mels[i] for i in range(len(reqs))])
    out["tp_eager"] = srv.engine._collective()

    p = inp["picard"]
    cfm = TC.CFM(inp["model_cfg"].arch)
    cfm.load_state_dict(inp["cfm_state"])
    dit = cfm.transformer.eval()
    for tables in (False, True):
        opts = TC.SampleOptions(steps=8, time_parallel_window=4, picard_tol=0.0,
                                precompute_adaln=tables)
        for dp, mesh in ((2, meshes[2]), (4, data4)):
            out[("picard", dp, tables)] = TC.sample(dit, inp["model_cfg"].arch, *p["args"],
                                                    lens=p["lens"], opts=opts,
                                                    time_parallel_mesh=mesh)
    try:
        TC.sample(dit, inp["model_cfg"].arch, *p["args"], lens=p["lens"],
                  opts=TC.SampleOptions(steps=8, time_parallel_window=3, picard_tol=0.0),
                  time_parallel_mesh=data4)
        out["picard_refusal"] = None
    except ValueError as e:
        out["picard_refusal"] = str(e)
    picard = dict(nfe_step=4, time_parallel_window=4, picard_tol=0.0)
    eng = _engine(inp, **picard)
    eng.enable_time_parallel(data4)
    out["picard_engine"] = _gen(eng, inp)
    eng = _engine(inp, **picard)  # time x tp: rows over data, heads over model
    shard_params(eng.model.transformer, meshes[2])
    eng.tensor_parallel = True
    eng.enable_time_parallel(meshes[2])
    out["picard_tp"] = _gen(eng, inp)
    try:
        _engine(inp).enable_time_parallel(data4)
        out["no_window"] = None
    except ValueError as e:
        out["no_window"] = str(e)
    return out


# ------------------------------------------------------------------ pipeline


def pipe(rank, world, tmp, inp):
    """The GPipe pipeline: forwards at (pp, M) = (2, 2), (2, 4), (4, 4),
    (4, 2), with tensor parallelism at pp 2 x tp 2, the loss gradients at
    (2, 2) with and without tp, pp 2 x sp 2 on the ring (forward and the
    gradients summed over seq), the engine's block-scan hook; and ZeRO-1
    with Adafactor at data 2, with and without tp 2: one optimizer step on
    the parent's gradients, and one Trainer update."""
    from f5_tts_tpu_torch.parallel.mesh import make_mesh, make_train_mesh, shard_params
    from f5_tts_tpu_torch.parallel.pipeline import make_dit_block_scan, make_pp_mesh
    from f5_tts_tpu_torch.parallel.sequence import make_seq_constraint

    case = inp["dit"]
    cfg = case["cfg"]
    meshes = {2: make_pp_mesh(data=2, pipe=2), 4: make_pp_mesh(data=1, pipe=4)}
    pp_tp = make_pp_mesh(data=1, pipe=2, model=2)
    pp_sp = make_train_mesh(data=1, pipe=2, seq=2)
    out = {"stage": {2: meshes[2].get_local_rank("pipe"), 4: meshes[4].get_local_rank("pipe")}}
    for pp, M in ((2, 2), (2, 4), (4, 4), (4, 2)):
        model = _backbone(case)
        with torch.no_grad():
            out[("fwd", pp, M)] = _forward(case, model,
                                           block_scan=make_dit_block_scan(cfg, meshes[pp], M))
    for name, mesh in (("pp", meshes[2]), ("pp_tp", pp_tp)):
        model = _backbone(case)
        if name == "pp_tp":
            shard_params(model, mesh)
        y = _forward(case, model, block_scan=make_dit_block_scan(cfg, mesh, 2,
                                                                 backend="train_auto"))
        out[name] = dict(y=y.detach(), grads=_grads(model, y, inp["w"]))

    model = _backbone(case)
    hook = make_seq_constraint(pp_sp)
    y = _forward(case, model, activation_constraint=hook,
                 block_scan=make_dit_block_scan(cfg, pp_sp, 2, ring_sequence="auto"))
    grads = _grads(model, y, inp["w"])
    seq = pp_sp.get_group("seq")
    for g in grads.values():
        dist.all_reduce(g, group=seq)
    out["pp_sp"] = dict(y=y.detach(), grads=grads)

    eng = _engine(inp, nfe_step=2)
    eng.parallel_hooks = (make_dit_block_scan(eng.model_cfg.arch, meshes[2], 2), None, None)
    out["engine_scan"] = _gen(eng, inp)
    out["engine_scan_eager"] = eng._collective()

    for name, tp_ in (("ada_step", False), ("ada_step_tp", True)):
        out[name] = _optimizer_step(inp, _cfm(inp), make_mesh(data=2, model=2), inp["adafactor"],
                                    inp["ada_grads"], tensor_parallel=tp_, zero1=True)

    for name, tp_ in (("zero1_adafactor", False), ("zero1_adafactor_tp", True)):
        tr = _trainer(inp, os.path.join(tmp, name), mesh=make_mesh(data=2, model=2), zero1=True,
                      tensor_parallel=tp_, opt=inp["adafactor"])
        model, _, _ = tr.train(_cfm(inp), _dataset(inp), epochs=1, resume=False)
        full = tr.layout.full_state_dict(model) if tr.layout is not None else model.state_dict()
        state = tr.optimizer.inner.state
        out[name] = dict(params=full, state_bytes=tr.optimizer.state_bytes(),
                         sharded=sorted(k for p in state for k in tr.optimizer.inner.sharded.get(
                             p, ())))
        if rank == 0:
            out[name]["log"] = open(tr.log_file).read()
    return out


# ----------------------------------------------------------------- training


def _optimizer_step(inp, model, mesh, opt_cfg, grads, tensor_parallel=False, pipeline=False,
                    zero1=False):
    """One update of ``train/step.Optimizer`` on ``model`` (a CFM) under
    ``mesh`` from the one-device gradients ``grads`` {name: tensor}, as the
    Trainer builds it (``ModelLayout``, the stacks); returns the parameters
    in the one-device layout, AdamW's first moments (or Adafactor's sharded
    state keys) and the optimizer state's bytes on this rank."""
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.parallel.layout import ModelLayout
    from f5_tts_tpu_torch.train.step import make_optimizer
    from f5_tts_tpu_torch.utils.ckpt import stacked_leaf

    lay = ModelLayout(model, mesh, tensor_parallel=tensor_parallel, pipeline=pipeline)
    lay.apply_(model)
    data = M.axis_group(mesh, M.DATA_AXIS) if zero1 else None
    opt = make_optimizer(lay.live_params(model), opt_cfg, zero1_group=data,
                         layout=lay,
                         stacks=[stacked_leaf(n, inp["train_cfg"].arch) for n in lay.live])
    assert opt.step([lay.local(n, grads[n]).clone() for n in lay.live])
    out = dict(params=lay.full_state_dict(model), state_bytes=opt.state_bytes())
    if opt_cfg.optimizer == "adamw":
        out["moments"] = dict(zip(lay.names, lay.gather_live(
            [opt.inner.state[p]["exp_avg"] for p in lay.live_params(model)], "cpu")))
    else:
        out["sharded"] = sorted({k for p in opt.inner.state for k in opt.inner.sharded.get(p, ())})
    return out


def loss_case(inp, mesh):
    """The loss and its gradients on injected draws (``inp["loss_case"]``,
    the global batch; this data rank's rows) at data 2 x pipe 2 x model 2
    through the pipeline's hook, summed over data; then one AdamW update
    and one ZeRO-1 Adafactor update from those gradients."""
    import copy

    from f5_tts_tpu_torch.models import cfm as TC
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.parallel.layout import ModelLayout
    from f5_tts_tpu_torch.parallel.pipeline import make_dit_block_scan
    from f5_tts_tpu_torch.train.step import all_reduce_sum_

    g = inp["loss_case"]
    arch = inp["train_cfg"].arch
    data = M.axis_group(mesh, M.DATA_AXIS)
    per = g["mel"].shape[0] // 2
    r = M.axis_rank(mesh, M.DATA_AXIS)
    rows = slice(r * per, (r + 1) * per)
    model = _cfm(inp)
    fresh = copy.deepcopy(model)
    lay = ModelLayout(model, mesh, tensor_parallel=True, pipeline=True)
    lay.apply_(model)
    inject = {k: (v[rows] if torch.is_tensor(v) else v) for k, v in g["inject"].items()}
    loss = TC.loss(model.transformer, arch, g["mel"][rows], g["text_ids"][rows], g["lens"][rows],
                   valid=g["valid"][rows], inject=inject, backend="train_auto", count_group=data,
                   block_scan=make_dit_block_scan(arch, mesh, 2, backend="train_auto"))
    grads = list(torch.autograd.grad(loss, lay.live_params(model)))
    all_reduce_sum_(grads, data)
    total = loss.detach().clone()
    dist.all_reduce(total, group=data)
    full = dict(zip(lay.names, lay.gather_live(grads, "cpu")))
    out = dict(loss=total.item(), grads=full, norm=lay.global_norm(grads).item())
    for name, opt in (("adamw", inp["opt"]), ("adafactor", inp["adafactor"])):
        out[name] = _optimizer_step(inp, copy.deepcopy(fresh), mesh, opt, full,
                                    tensor_parallel=True, pipeline=True,
                                    zero1=name == "adafactor")
    return out


def _dataset(inp):
    from f5_tts_tpu_torch.train.dataset import CustomDataset

    return CustomDataset(inp["rows"], preprocessed_mel=True)


def _cfm(inp):
    from f5_tts_tpu_torch.models.cfm import CFM

    m = CFM(inp["train_cfg"].arch)
    m.load_state_dict(inp["init"])
    return m


def _trainer(inp, ckpt, opt=None, **kw):
    from f5_tts_tpu_torch.train.trainer import Trainer

    base = dict(batch_size_per_device=4, batch_size_type="sample", save_per_updates=1000,
                last_per_updates=1000, seed=3, device="cpu", log_every_updates=1)
    base.update(kw)
    return Trainer(inp["train_cfg"], None, opt or inp["opt"], ckpt_dir=ckpt, **base)


def train(rank, world, tmp, inp):
    """On 8 ranks: ``loss_case`` at data 2 x pipe 2 x model 2; one Trainer
    update at data 2 x pipe 2 x model 2 and at
    pipe 2 x seq 2 x model 2 (dp x pp x sp x tp with data 1), each with its
    gathered checkpoint and this rank's shards held against it; the first
    run's checkpoint resumed for a second epoch under the second mesh; then
    the CLI under a world of 8 with ``--tensor_parallel 2
    --pipeline_parallel 2 --pipeline_microbatches 2 --zero1``."""
    from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
    from f5_tts_tpu_torch.parallel.mesh import make_train_mesh

    out = {"loss_case": loss_case(inp, make_train_mesh(data=2, pipe=2, model=2))}
    try:  # UNetT's forward takes no block_scan (JAX fails at its first step)
        _trainer(dict(inp, train_cfg=MODEL_CONFIGS["E2TTS_Base"]), os.path.join(tmp, "unett"),
                 mesh=make_train_mesh(data=2, pipe=2, model=2), pipeline_microbatches=2)
        out["pp_unett"] = None
    except ValueError as e:
        out["pp_unett"] = str(e)
    for name, kw in (("dp_pp_tp", dict(data=2, pipe=2, model=2)),
                     ("pp_sp_tp", dict(data=1, pipe=2, seq=2, model=2))):
        ck = os.path.join(tmp, name)
        tr = _trainer(inp, ck, mesh=make_train_mesh(**kw), tensor_parallel=True,
                      pipeline_microbatches=2, sequence_parallel="seq" in kw)
        model, ema, update = tr.train(_cfm(inp), _dataset(inp), epochs=1, resume=False)
        lay = tr.layout
        dist.barrier()  # rank 0 has written model_last.pt
        ckpt = torch.load(os.path.join(ck, "model_last.pt"), weights_only=True)
        full = ckpt["model_state_dict"]
        local = dict(model.named_parameters())
        out[name] = dict(
            update=update, live=len(lay.live), names=len(lay.names),
            shards_bitwise=all(torch.equal(lay.local(k, full[k]), local[k].detach())
                               for k in lay.live),
            tp_shapes={k: tuple(local[k].shape) for k in lay.live if lay.tp_dim[k] is not None},
            stage=lay.stage)
        if rank == 0:
            out[name].update(log=open(tr.log_file).read(), ckpt=ckpt)

    # resume dp_pp_tp's checkpoint under another mesh for a second epoch
    ck = os.path.join(tmp, "resume")
    if rank == 0:
        os.makedirs(ck)
        shutil.copy(os.path.join(tmp, "dp_pp_tp", "model_last.pt"), ck)
    dist.barrier()
    tr = _trainer(inp, ck, mesh=make_train_mesh(data=1, pipe=2, seq=2, model=2),
                  tensor_parallel=True, pipeline_microbatches=2, sequence_parallel=True)
    _, _, update = tr.train(_cfm(inp), _dataset(inp), epochs=2, resume=True)
    dist.barrier()
    out["resume"] = dict(update=update)
    if rank == 0:
        out["resume"].update(log=open(tr.log_file).read(), ckpt=torch.load(
            os.path.join(ck, "model_last.pt"), weights_only=True))

    from f5_tts_tpu_torch.train import cli as TCLI
    from f5_tts_tpu_torch.train import dataset as TDS
    from f5_tts_tpu_torch.train import trainer as TT

    TDS.load_dataset = lambda *a, **k: TDS.CustomDataset(inp["cli_rows"], preprocessed_mel=True)
    seen = {}
    real = TT.Trainer

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.update(mesh=(tuple(self.mesh.mesh_dim_names), tuple(self.mesh.shape)),
                        tensor_parallel=self.tensor_parallel,
                        pipeline_microbatches=self.pipeline_microbatches, zero1=self.zero1)

    TT.Trainer = Recording
    ck = os.path.join(tmp, "cli")
    try:
        TCLI.main(["--model", "F5TTS_Tiny", "--device", "cpu", "--epochs", "1", "--ckpt_dir", ck,
                   "--batch_size_per_gpu", "400", "--tensor_parallel", "2",
                   "--pipeline_parallel", "2", "--pipeline_microbatches", "2", "--zero1",
                   "++optim.num_warmup_updates=1", "++ckpts.last_per_updates=1"])
    finally:
        TT.Trainer = real
    out["cli"] = dict(seen, exists=os.path.exists(os.path.join(ck, "model_last.pt")),
                      log=open(os.path.join(ck, "train_log.jsonl")).read() if rank == 0 else "")
    return out
