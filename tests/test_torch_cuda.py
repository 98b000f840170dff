"""The CUDA kernels against their plain versions on the card. Marked
``cuda``: they skip without a GPU. On a machine with one:
``python -m pytest tests/test_torch_cuda.py -m cuda``."""
import pytest
import torch

from s4former_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels have no CPU mode)')
    return torch.device('cuda')


@pytest.mark.parametrize('bias_heads', [None, 1, 3])
@pytest.mark.parametrize('length', [130, 257])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda, bias_heads, length, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, h, d = 2, 3, 64
    qkv = torch.randn((b, length, 3 * h * d), generator=g, device=cuda)
    q, k, v = [t.view(b, length, h, d)
               for t in qkv.to(dtype).split(h * d, -1)]
    bias = None if bias_heads is None else torch.randn(
        (b, bias_heads, length, length), generator=g, device=cuda)
    before = fa.launch_count
    o, lse = fa.flash_attention_fwd(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, bias)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-3
