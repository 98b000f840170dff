"""The kernels' build helpers on the CPU (no nvcc needed): the library name
follows the headers a source includes, and the parsers of the compiler's
log and of cuobjdump's SASS count what each kernel function holds; the
bf16 launchers' alignment check."""
import shutil

import pytest
import torch

from s4former_tpu_torch.ops import cuda_build
from s4former_tpu_torch.ops import flash_attention as fa

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _ZN12_GLOBAL__N_124flash_attn_fwd_tc_kernelILb1EEEvNS_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000fe40000000800 */
        /*0010*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;  /* 0x0000000004037fae */
                                                                                /* 0x0001e2000b981a04 */
        /*0020*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R3+0x800], desc[UR4][R6.64] ;
        /*0030*/                   LDSM.16.M88.4 R8, [R2] ;
        /*0040*/                   HMMA.16816.F32.BF16 R24, R8, R12, R24 ;
        /*0050*/                   HMMA.16816.F32.BF16 R28, R8.reuse, R14, R28 ;
        /*0060*/               @P1 HMMA.16816.F32.BF16 R32, R8, R16, RZ ;
        /*0070*/                   EXIT ;
		..........

		Function : _ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLb1EEEvNS_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0020*/                   FFMA R5, R4, R6, R5 ;
        /*0030*/                   EXIT ;
"""

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124flash_attn_fwd_tc_kernelILb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124flash_attn_fwd_tc_kernelILb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 568 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLb1EEEvNS_6ParamsE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 568 bytes cmem[0]
"""

TC = '_ZN12_GLOBAL__N_124flash_attn_fwd_tc_kernelILb1EEEvNS_6ParamsE'
FMA = '_ZN12_GLOBAL__N_121flash_attn_fwd_kernelIfLb1EEEvNS_6ParamsE'


def test_sass_counts_per_function():
    """Predicated instructions count; LDSM (ldmatrix), LDG and FFMA do not;
    the comment lines with the encodings are not instructions."""
    assert cuda_build.sass_counts(SASS) == {
        TC: {'tensor_core': 3, 'async_copy': 2},
        FMA: {'tensor_core': 0, 'async_copy': 0}}


def test_sass_counts_hopper_ops():
    sass = ('Function : k\n'
            '        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, '
            'gdesc[UR8], RZ, !UPT ;\n'
            '        /*0010*/              @!UP0 UTMALDG.2D [UR8], [UR4] ;\n')
    assert cuda_build.sass_counts(sass) == {
        'k': {'tensor_core': 1, 'async_copy': 1}}


def test_ptxas_info_per_function():
    assert cuda_build.ptxas_info(PTXAS) == {
        TC: {'registers': 128, 'spill_stores': 0, 'spill_loads': 0},
        FMA: {'registers': 255, 'spill_stores': 12, 'spill_loads': 16}}


@pytest.mark.parametrize('edit,changes', [
    ('flash_attn_tc.cuh', {'flash_attn_fwd.cu', 'flash_attn_bwd.cu'}),
    ('flash_attn_fwd.cu', {'flash_attn_fwd.cu'}),
    ('unrelated.cuh', set())])
def test_library_name_follows_included_headers(tmp_path, monkeypatch, edit,
                                               changes):
    """An edit to a header that a source includes renames the source's
    library, so a stale build is never loaded; a header no source includes
    renames nothing."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    (csrc / 'unrelated.cuh').write_text('// included by no source\n')
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', csrc)
    sources = ('flash_attn_fwd.cu', 'flash_attn_bwd.cu')
    before = {s: cuda_build.library_path(s) for s in sources}
    with open(csrc / edit, 'a') as f:
        f.write('\n// edited\n')
    after = {s: cuda_build.library_path(s) for s in sources}
    assert {s for s in sources if before[s] != after[s]} == changes
    for s in sources:
        assert after[s].name.startswith(s.replace('.cu', '-'))


def test_sources_include_the_shared_header():
    for source in ('flash_attn_fwd.cu', 'flash_attn_bwd.cu'):
        names = [f.name for f in cuda_build.source_files(source)]
        assert names == [source, 'flash_attn_tc.cuh']


def test_tc_alignment_check():
    """q, k, v as the ViT makes them (views of one fused qkv) pass; a view
    one element off, or a row stride that is not a multiple of 16 bytes,
    raises."""
    b, l, h, d = 2, 5, 3, 64
    qkv = torch.zeros((b, l, 3 * h * d), dtype=torch.bfloat16)
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, -1))
    fa.check_tc_alignment(q=q, k=k, v=v)
    flat = torch.zeros(b * l * h * d + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='q must be 16-byte aligned'):
        fa.check_tc_alignment(q=flat[1:].view(b, l, h, d), k=k, v=v)
    wide = torch.zeros((b, l, h * d + 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='v must be'):
        fa.check_tc_alignment(q=q, k=k, v=wide[..., :h * d].view(b, l, h, d))
