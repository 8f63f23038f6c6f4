"""The port's runtime layer on the CPU: FLOP accounting against the JAX
package's (exactly: the same arithmetic), the H100 peaks, the profiling
helpers, the offline serving benchmark and the training-throughput script
at tiny sizes."""

import torch_threads  # noqa: F401  (first: caps torch's threads per test worker)

import json
import os

import pytest
import torch

from f5_tts_tpu.infer import serve as JS
from f5_tts_tpu.models.configs import MODEL_CONFIGS as JAX_CONFIGS
from f5_tts_tpu.utils import flops as JF
from f5_tts_tpu_torch.models.configs import MODEL_CONFIGS
from f5_tts_tpu_torch.utils import flops as TF
from f5_tts_tpu_torch.utils import profiling
from f5_tts_tpu_torch.utils.profiling import device_trace

NS = (64, 256, 1000, 1024)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_flops_equal_jax_exactly(name):
    """Every function at a few lengths, text lengths, NFEs and batches."""
    tc, jc = MODEL_CONFIGS[name], JAX_CONFIGS[name]
    for n in NS:
        for nt in (None, 32, n // 2):
            assert TF.backbone_forward_flops(tc.arch, n, nt) == \
                JF.backbone_forward_flops(jc.arch, n, nt)
        kind = getattr(tc.arch, "backbone", "DiT")
        if kind == "DiT":
            assert TF.dit_text_embed_flops(tc.arch, n) == JF.dit_text_embed_flops(jc.arch, n)
            assert TF.dit_forward_flops(tc.arch, n) == JF.dit_forward_flops(jc.arch, n)
        elif kind == "UNetT":
            assert TF.unett_forward_flops(tc.arch, n) == JF.unett_forward_flops(jc.arch, n)
        else:
            assert TF.mmdit_forward_flops(tc.arch, n, 77) == JF.mmdit_forward_flops(jc.arch, n, 77)
        assert TF.vocos_forward_flops(n) == JF.vocos_forward_flops(n)
        for nfe in (1, 16, 32):
            for batch in (1, 3):
                for fused in (True, False):
                    for voc in ("vocos", "bigvgan"):
                        assert TF.sampling_flops(tc, nfe, n, batch, fused, voc) == \
                            JF.sampling_flops(jc, nfe, n, batch, fused, voc)
        for batch in (1, 37):
            assert TF.train_step_flops(tc, n, batch) == JF.train_step_flops(jc, n, batch)


def test_mfu_uses_the_h100_peaks():
    assert (TF.H100_BF16_PEAK_FLOPS, TF.H100_INT8_PEAK_OPS, TF.H100_TF32_PEAK_FLOPS,
            TF.H100_FP32_PEAK_FLOPS) == (989e12, 1979e12, 495e12, 67e12)
    assert TF.mfu(989e12) == 1.0 and TF.mfu(98.9e12) == pytest.approx(0.1)
    assert TF.mfu(495e12, peak=TF.H100_TF32_PEAK_FLOPS) == 1.0
    # the sampler counts nothing for BigVGAN, as JAX
    cfg = MODEL_CONFIGS["F5TTS_Base"]
    assert TF.sampling_flops(cfg, 32, 512, vocoder="bigvgan") + TF.vocos_forward_flops(512) \
        == TF.sampling_flops(cfg, 32, 512, vocoder="vocos")


def test_phase_timer_report(tmp_path):
    """JAX's ``PhaseTimer`` report, from the tracer's spans."""
    profiling.clear()
    profiling.enable()
    try:
        for _ in range(3):
            with profiling.span("dit"):
                pass
        with profiling.span("vocoder"):
            pass
    finally:
        profiling.disable()
    rep = profiling.report()
    assert list(rep) == ["dit", "vocoder"]
    assert rep["dit"]["count"] == 3 and rep["vocoder"]["count"] == 1
    assert rep["dit"]["total_s"] >= 0 and rep["dit"]["mean_ms"] >= 0
    profiling.dump(str(tmp_path / "phases.json"))
    assert json.load(open(tmp_path / "phases.json")) == rep
    profiling.clear()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.load(open(os.path.join(tmp_path, "trace.json")))
    assert trace["traceEvents"]


def test_runtime_benchmark_tiny():
    """tests/test_serve.py's benchmark case, on the port: the same report
    keys as JAX's rtf_report, plus the timed pass's engine calls and FLOPs."""
    from f5_tts_tpu_torch.runtime import benchmark as RB

    rep = RB.main(["--model", "F5TTS_Tiny", "--device", "cpu", "--backend-type", "sdpa",
                   "--nfe", "2", "--num-prompts", "3", "--batch-size", "2"])
    assert rep["rtf"] > 0 and rep["total_audio_s"] > 0
    assert rep["backend"] == "sdpa" and rep["nfe"] == 2
    jax_keys = set(JS.rtf_report([], [0.1], 24_000))
    assert jax_keys | {"wall_s", "wall_rtf", "backend", "nfe"} <= set(rep)
    assert sum(rep["engine_calls"].values()) == 2  # 3 prompts in batches of 2
    assert rep["model_tflop"] > 0 and rep["mfu_pct"] is None  # no MFU off the card
    assert rep["kernel_launches"] == {}  # the CPU runs the plain versions


def test_bench_train_one_tiny_update(capsys):
    from f5_tts_tpu_torch.scripts import bench_train

    rec = bench_train.main(["1", "fp32", "train_auto", "none", "64", "1", "F5TTS_Tiny", "cpu",
                            "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == rec
    assert set(line) == {"metric", "value", "unit", "model_tflops_per_s", "mfu_pct"}
    assert line["metric"] == "train_frames_per_s" and line["value"] > 0


def test_bench_train_chunked_backend_raises():
    """JAX's default backend, ``chunked``, is ported and runs; a backend
    ``attention`` does not know still raises."""
    from f5_tts_tpu_torch.scripts import bench_train

    rec = bench_train.main(["1", "fp32", "chunked", "none", "32", "1", "F5TTS_Tiny", "cpu", "1"])
    assert rec["metric"] == "train_frames_per_s" and rec["value"] > 0
    with pytest.raises(ValueError, match="unknown attention backend"):
        bench_train.main(["1", "fp32", "ring", "none", "32", "1", "F5TTS_Tiny", "cpu", "1"])


def _opcheck_cases():
    """(op, args) of A (prefix and two-segment mode), B (with and without
    taps) and G's serving instance (with and without a bias), on the CPU."""
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.ops import quant as Q

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 2, 16, 64), generator=g) for _ in range(3))
    lens, lens2 = torch.tensor([16, 9], dtype=torch.int32), torch.tensor(
        [[10, 3], [4, 0]], dtype=torch.int32)
    x = torch.randn((2, 12, 128), generator=g)
    w1, w2 = (torch.randn((128, 64, 31), generator=g) * 0.05 for _ in range(2))
    b1, b2 = (torch.randn(128, generator=g) for _ in range(2))
    t1, t2 = (FC.kernel_taps(w, 2, x.dtype) for w in (w1, w2))
    xl = torch.randn((3, 5, 32), generator=g).to(torch.bfloat16)
    w_q, ws = Q.quantize_weight(torch.randn((8, 32), generator=g))
    bias = torch.randn(8, generator=g).to(torch.bfloat16)
    return {
        "A": (FA.flash_attention_op, (q, k, v, lens)),
        "F": (FA.flash_attention_op, (q, k, v, lens2, 12)),
        "B": (FC.conv_pos_op, (x, w1, b1, w2, b2, torch.tensor([12, 7], dtype=torch.int32), 2)),
        "B_taps": (FC.conv_pos_op, (x, w1, b1, w2, b2, torch.tensor([12, 7], dtype=torch.int32),
                                    2, t1, t2)),
        "G": (Q.linear_w8a8, (xl, w_q, ws, bias)),
        "G_no_bias": (Q.linear_w8a8, (xl, w_q, ws)),
    }


@pytest.mark.parametrize("case", ["A", "F", "B", "B_taps", "G", "G_no_bias"])
def test_kernel_ops_pass_opcheck(case):
    """The dispatcher ops of kernels A, B and G (schema, fake
    implementation, autograd registration, AOT dispatch) on their CPU
    implementations, which equal the plain versions."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)
    from f5_tts_tpu_torch.ops import flash_attention as FA
    from f5_tts_tpu_torch.ops import fused_convpos as FC
    from f5_tts_tpu_torch.ops import quant as Q

    plain = {"A": FA.flash_attention_plain, "F": FA.flash_attention_plain,
             "B": FC.conv_pos_plain, "B_taps": lambda *a: FC.conv_pos_plain(*a[:7]),
             "G": Q.linear_w8a8_plain, "G_no_bias": Q.linear_w8a8_plain}[case]
    assert torch.equal(op(*args), plain(*args))


@pytest.mark.parametrize("case", ["A", "B", "G"])
def test_kernel_ops_refuse_the_meta_device(case):
    op, args = _opcheck_cases()[case]
    with pytest.raises(ValueError, match="no implementation"):
        op(*(a.to("meta") if torch.is_tensor(a) else a for a in args))
