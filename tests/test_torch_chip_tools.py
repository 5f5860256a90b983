"""chip_smoke.py's own tools that need no card: the SASS path counter
behind #8's issue-time estimate, on a listing shaped like cuobjdump's."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_118permute_pad_kernelEPKhPKfPKiPhPfiiii
        /*0000*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0010*/                   EXIT ;                                 /* 0x000000000000794d */
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_119swiglu_quant_kernelEPK13__nv_bfloat16PhPfii
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/              @P0 BRA 0x50 ;                              /* 0x0000000000000947 */
        /*0030*/                   MOV R16, 0x50 ;                        /* 0x0000000400027824 */
        /*0040*/                   CALL.REL.NOINC 0xa0 ;                  /* 0x0000000000007944 */
        /*0050*/                   FMUL R3, R2, R2 ;                      /* 0x0000000202037220 */
        /*0060*/                   EXIT ;                                 /* 0x000000000000794d */
        /*0070*/                   BRA 0x70;                              /* 0x0000000000002947 */
        /*0080*/                   NOP;                                   /* 0x0000000000007918 */
        /*0090*/                   NOP;                                   /* 0x0000000000007918 */
        /*00a0*/                   MUFU.RCP R5, R3 ;                      /* 0x0000000300057308 */
        /*00b0*/                   RET.REL.NODEC R6 0x0 ;                 /* 0x0000000006007950 */
\t\t..........
"""


@pytest.mark.parametrize("kernel,n", [("swiglu_quant_kernel", 7),
                                      ("permute_pad_kernel", 2),
                                      ("fp8_transpose_kernel", None)])
def test_path_length_counts_the_main_path(kernel, n):
    """Instructions 0x00-0x60 of the SwiGLU kernel (the call site's two
    included; the self-branch, the NOPs and the subroutine at the CALL
    target excluded); a function without calls to its end; None for a
    kernel the listing lacks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert chip_smoke.path_length(LISTING, kernel) == n
