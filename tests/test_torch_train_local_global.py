"""Training gemma2_9b (GeGLU, local:global, attention and final softcaps)
in all four recipes and gemma3_4b (GeGLU, qk-norm, 5 local : 1 global)
in fp8_flow against the JAX reference on the CPU, to
tests/test_torch_train_gelu_moe.py's bars, at reduced() size with window
8 (the 64-token rows then cross it).  reduced() gemma3_4b has 2 layers,
which the pattern fallback makes both local; at 6 layers, one whole
pattern group, its global layer trains too (autograd through the
windowed and the full flash attention), held to the six-layer bar, and
again with the port on the reference XLA route's bf16 roundings, which
leave the six-layer drift where it is (tests/test_torch_train_gelu_moe.py);
the two six-layer cases share one reference run."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import pytest

from test_torch_train_gelu_moe import (DEEP_GRAD_COSINE, check_training,
                                       xla_route_roundings)


@pytest.mark.parametrize("name", ["fp8_flow", "bf16", "blockwise",
                                  "naive_fp8"])
def test_gemma2_loss_grads_and_ledger_match_reference(name):
    check_training("gemma2_9b", name)


def test_gemma3_loss_grads_and_ledger_match_reference():
    check_training("gemma3_4b", "fp8_flow")


def test_gemma3_one_pattern_group_matches_reference():
    check_training("gemma3_4b", "fp8_flow", dict(window=8, n_layers=6),
                   DEEP_GRAD_COSINE)


def test_gemma3_one_pattern_group_with_xla_route_roundings():
    check_training("gemma3_4b", "fp8_flow", dict(window=8, n_layers=6),
                   DEEP_GRAD_COSINE, port_route=xla_route_roundings)
