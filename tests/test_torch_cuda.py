"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (the kernels have no
CPU mode; a CPU tensor runs the plain version instead).  The file imports
no JAX, so it runs on the GPU machine, where the repository's conftest
(which configures JAX) is skipped:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: bf16 inputs, and both kernels round to bf16 where the TPU
kernels do, against plain versions computed in fp32 on the same values.
"""

import pytest
import torch

from f5_tts_tpu_torch.ops import flash_attention as FA
from f5_tts_tpu_torch.ops import fused_convpos as FC

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n,lens", [(200, [200, 163]), (1000, [0, 963]), (65, [65, 1])])
def test_flash_kernel_matches_plain(gen, n, lens):
    q, k, v = (torch.randn((2, 16, n, 64), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = FA.KERNEL.launches
    got = FA.flash_attention(q, k, v, lens_t).float()
    assert FA.KERNEL.launches == before + 1
    want = FA.flash_attention_plain(q.float(), k.float(), v.float(), lens_t)
    err = (got - want).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3
    if 0 in lens:
        assert torch.all(got[lens.index(0)] == 0)


def test_flash_kernel_takes_fp32_and_rejects_other_head_dims(gen):
    q = torch.randn((1, 2, 100, 64), generator=gen, device="cuda")
    lens = torch.tensor([70], dtype=torch.int32, device="cuda")
    got = FA.flash_attention(q, q, q, lens)
    assert got.dtype == torch.float32
    assert (got - FA.flash_attention_plain(q, q, q, lens)).abs().max().item() < 2e-2
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q[..., :32].contiguous(), q[..., :32].contiguous(),
                           q[..., :32].contiguous(), lens)


@pytest.mark.parametrize("n", [1, 300])
def test_convpos_kernel_matches_plain(gen, n):
    d, groups = 1024, 16
    bound = (64 * 31) ** -0.5
    w1, w2 = ((torch.rand((d, 64, 31), generator=gen, device="cuda") * 2 - 1) * bound
              for _ in range(2))
    b1, b2 = ((torch.rand((d,), generator=gen, device="cuda") * 2 - 1) * bound for _ in range(2))
    x = torch.randn((2, n, d), generator=gen, device="cuda")
    args = [t.to(torch.bfloat16) for t in (x, w1, b1, w2, b2)]
    lens = torch.tensor([n, max(n - 37, 0)], dtype=torch.int32, device="cuda")
    before = FC.KERNEL.launches
    got = FC.conv_pos_fused(*args, lens, groups=groups).float()
    assert FC.KERNEL.launches == before + 1
    want = FC.conv_pos_plain(*[a.float() for a in args], lens, groups)
    err = (got - want).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 2e-3


def test_convpos_kernel_rejects_other_group_widths(gen):
    x = torch.zeros((1, 8, 64), device="cuda")
    w = torch.zeros((64, 4, 31), device="cuda")
    b = torch.zeros((64,), device="cuda")
    with pytest.raises(ValueError, match="64-channel groups"):
        FC.conv_pos_fused(x, w, b, w, b, torch.tensor([8], dtype=torch.int32, device="cuda"),
                          groups=16)
