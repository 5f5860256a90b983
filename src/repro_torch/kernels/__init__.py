"""The port's hand-written Hopper kernels (serving and training paths,
padded and masked expert layouts).

Each kernel module holds the plain PyTorch twin (``*_plain``), the CUDA
launch (``*_cuda``, source under ``repro_torch/csrc``) and a note naming
the TPU kernel it replaces.  ``kernels.ops`` picks by device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the twin.

``LAUNCHES`` counts kernel launches: each ``*_cuda`` function adds one where
it launches and nowhere else, so a run can show that its main path went
through the kernels.  A kernel's modes that a recipe selects (the linear
scales of the quantize) count apart from its default.  ``adamw_update``
(the optimizer's fused update) replaces no TPU kernel: the reference's
AdamW is XLA.
"""
from __future__ import annotations

KERNELS = ("quantize_rowwise", "fused_permute_pad", "grouped_gemm_fp8",
           "fused_swiglu_quant", "fp8_transpose", "grouped_gemm_nt_fp8",
           "grouped_gemm_fp8_quant_out", "masked_grouped_gemm_fp8",
           "masked_grouped_gemm_fp8_quant_out",
           "masked_grouped_gemm_swiglu_quant", "masked_grouped_gemm_nt_fp8",
           "quantize_rowwise_linear", "adamw_update")

LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda_input(t, name: str, dtype, ndim: int) -> None:
    """What every launcher takes: a contiguous CUDA tensor of the stated
    dtype and rank whose data starts on a 16-byte boundary."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
