"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``): the model-FLOP counts of all
twelve configs, the ``Roofline`` record on the same counts with the
reference's constants patched to the H100's, and ``tally()``, which counts
what a step runs where the reference reads XLA's cost analysis: each
grouped GEMM of the fp8_flow expert FFN, forward and backward, at exactly
2 E C K N FLOPs, the twins' own matmuls not counted, the masked kernels'
live tiles only, and a MoE train step's kernel GEMMs at the analytic
count of its remat policy."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_arch as jget_arch
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.linear import expert_ffn, quantize_entry
from repro_torch.core.moe import MoEConfig, moe_block, moe_block_overlapped
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.roofline import analysis

MASKED = dict(masked_experts=True, swiglu_epilogue=True)


def test_model_flops_equal_the_references_for_every_config():
    assert list(ARCH_IDS) == list(JARCH_IDS)
    for arch in ARCH_IDS:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        for tokens in (1, 4096):
            assert analysis.model_flops_train(cfg, tokens) == \
                janalysis.model_flops_train(jcfg, tokens), arch
            assert analysis.model_flops_decode(cfg, tokens) == \
                janalysis.model_flops_decode(jcfg, tokens), arch


def test_h100_constants_and_chip_smoke_peaks():
    assert analysis.PEAK_FLOPS_BF16 == 989e12
    assert analysis.PEAK_FLOPS_FP8 == 1979e12
    assert analysis.HBM_BW == 3.35e12 and analysis.NVLINK_BW == 450e9
    assert analysis.PEAKS == dict(bw=3.35e12, fp8=1979e12, bf16=989e12,
                                  f32=67e12)


@pytest.mark.parametrize("flops,hbm,model", [
    (3.1e15, 2.2e12, 1.7e15), (1e12, 9e12, 4e11), (0.0, 0.0, 0.0)])
def test_roofline_record_is_the_references(monkeypatch, flops, hbm, model):
    monkeypatch.setattr(janalysis, "PEAK_FLOPS_BF16",
                        analysis.PEAK_FLOPS_BF16)
    monkeypatch.setattr(janalysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(janalysis, "ICI_BW", analysis.NVLINK_BW)
    kw = dict(flops=flops, hbm_bytes=hbm, coll_bytes=0.0, coll_by_kind={},
              model_flops=model, n_chips=1)
    assert analysis.Roofline(**kw).to_dict() == \
        janalysis.Roofline(**kw).to_dict()
    # a collective term, as item 7 will fill it
    kw.update(coll_bytes=5e11, coll_by_kind={"all-to-all": 5e11})
    assert analysis.Roofline(**kw).to_dict() == \
        janalysis.Roofline(**kw).to_dict()


def _ffn(recipe, mm=None, E=2, C=256, K=256, F=128, seed=0):
    r = np.random.default_rng(seed)
    xe = torch.tensor(r.normal(size=(E, C, K)).astype(np.float32))
    if mm is not None:             # the dispatch layout: dead rows zero
        xe = xe * (torch.arange(C)[None, :, None] < torch.tensor(mm)[:, None,
                                                                   None])
    xe = xe.to(torch.bfloat16).requires_grad_()
    w13 = torch.tensor(r.normal(size=(E, K, 2 * F)).astype(np.float32)
                       * 0.05).to(torch.bfloat16).requires_grad_()
    w2 = torch.tensor(r.normal(size=(E, F, K)).astype(np.float32)
                      * 0.05).to(torch.bfloat16).requires_grad_()
    masked_m = torch.tensor(mm, dtype=torch.int32) \
        if recipe.masked_experts else None
    with analysis.tally() as t:
        y = expert_ffn(recipe, "swiglu", quantize_entry(recipe, xe), w13, w2,
                       masked_m)
        (y.to(torch.float32) ** 2).sum().backward()
    return t


def test_tally_counts_each_expert_gemm_exactly():
    """fp8_flow's FFN, forward and backward: GEMM-1, GEMM-2, Dgrad-2, the h
    recompute and the quant-out Dgrad-1 on the NN kernel, Wgrad-2 and
    Wgrad-1 on the NT kernel, each at 2 E C K N; the twins' own matmuls are
    not counted (no aten FLOPs at all)."""
    E, C, K, F = 2, 256, 256, 128
    t = _ffn(get_recipe("fp8_flow"), E=E, C=C, K=K, F=F)
    g1, g2 = 2 * E * C * K * 2 * F, 2 * E * C * F * K
    assert t.kernel_flops_each("grouped_gemm_fp8") == [g1, g2, g2, g1]
    assert t.kernel_flops_each("grouped_gemm_fp8_quant_out") == [g1]
    assert t.kernel_flops_each("grouped_gemm_nt_fp8") == [g2, g1]
    assert t.aten_flops == 0.0
    assert t.gemm_flops == 3 * g1 + 3 * g2 + g1
    ks = t.kernels()
    assert ks["quantize_rowwise"]["launches"] == 3      # entry, island, dact
    assert ks["fp8_transpose"]["launches"] == 4
    assert t.flops > t.gemm_flops and t.hbm_bytes > t.aten_bytes > 0


def test_masked_tally_counts_live_tiles_only():
    """Two experts with 100 and 0 live rows of 256: the masked kernels do
    one 128-row tile of one expert, so their GEMM FLOPs are 1/4 of the
    padded kernels' on the same inputs."""
    mm = [100, 0]
    padded = _ffn(get_recipe("fp8_flow"), mm)
    masked = _ffn(get_recipe("fp8_flow", **MASKED), mm)
    assert masked.gemm_flops < padded.gemm_flops
    nn = masked.kernel_flops_each("masked_grouped_gemm_fp8")
    assert nn == [f / 4 for f in padded.kernel_flops_each(
        "grouped_gemm_fp8")[1:]]
    assert masked.kernels()["masked_grouped_gemm_swiglu_quant"][
        "launches"] == 1
    assert masked.hbm_bytes < padded.hbm_bytes


@pytest.mark.parametrize("n_chunks", [0, 2])
def test_moe_train_step_gemm_flops_are_analytic(n_chunks):
    """A reduced qwen3 train forward + backward (remat 'full': the kept h
    and expert output skip both forward GEMMs in the recompute): the
    kernels' GEMM FLOPs are 11 x 2 E C D F a MoE layer, C the padded rows
    an expert over all chunks; aten's are the attention, router and head
    matmuls; the roofline record reads the tally."""
    cfg = get_arch("qwen3_moe_235b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    B, S = 2, 64
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B), 0, device="cpu")
    from repro_torch.core.moe import DispatchPlan, _chunk_geometry
    plan = DispatchPlan(n_chunks=n_chunks, min_chunk_tokens=1) \
        if n_chunks else None
    with analysis.tally() as t:
        loss, _ = lm.forward(cfg, get_recipe("fp8_flow"), params, batch,
                             plan=lm.ParallelPlan(moe_overlap=plan))
        loss.backward()
    n = max(n_chunks, 1)
    rc = get_recipe("fp8_flow")
    mcfg = MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     d_model=cfg.d_model, d_ff=cfg.d_ff_expert,
                     capacity_factor=cfg.capacity_factor)
    C = n * _chunk_geometry(rc, mcfg, B * S, n, 1, cfg.n_experts)[3]
    unit = 2 * cfg.n_experts * C * cfg.d_model * cfg.d_ff_expert
    kernel_gemm = t.gemm_flops - t.aten_flops
    assert kernel_gemm == 11 * unit * cfg.n_layers
    assert t.aten_flops > 0
    roof = analysis.analyze_tally(
        t, model_flops_global=analysis.model_flops_train(cfg, B * S))
    assert roof.flops == t.flops and roof.coll_bytes == 0.0
    assert roof.to_dict()["bottleneck"] in ("compute", "memory")


def test_tally_refuses_nesting_and_closes():
    with analysis.tally():
        with pytest.raises(RuntimeError):
            with analysis.tally():
                pass
    assert analysis._ACTIVE is None
    assert analysis.kernel("quantize_rowwise", None) is analysis._NULL


def test_overlapped_block_tally_matches_its_chunks():
    """The chunked fp8_flow block's kernels report their chunk shapes: at
    n = 2 the expert GEMMs run twice as often on half the capacity each."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_model=256, d_ff=128,
                    capacity_factor=4.0)
    r = np.random.default_rng(1)
    x = torch.tensor(r.normal(size=(256, 256)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    wr = torch.tensor(r.normal(size=(256, 4)).astype(np.float32) * 0.02)
    w13 = torch.tensor(r.normal(size=(4, 256, 256)).astype(np.float32)
                       * 0.05).requires_grad_()
    w2 = torch.tensor(r.normal(size=(4, 128, 256)).astype(np.float32)
                      * 0.05).requires_grad_()
    out = {}
    for n in (0, 2):
        with analysis.tally() as t:
            y, _ = (moe_block(get_recipe("fp8_flow"), cfg, x, wr, w13, w2)
                    if n == 0 else moe_block_overlapped(
                        get_recipe("fp8_flow"), cfg, x, wr, w13, w2,
                        n_chunks=n))
            (y.to(torch.float32) ** 2).sum().backward()
        out[n] = t.kernels()
    for k in ("grouped_gemm_fp8", "grouped_gemm_nt_fp8",
              "grouped_gemm_fp8_quant_out"):
        assert out[2][k]["launches"] == 2 * out[0][k]["launches"]
        assert out[2][k]["flops"] == out[0][k]["flops"], k
    # one entry quantize and one island quantize whatever n
    assert out[2]["quantize_rowwise"]["launches"] == \
        out[0]["quantize_rowwise"]["launches"] + 1      # dact: one a chunk


def test_dataclass_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(analysis.Roofline)] == \
        [f.name for f in dataclasses.fields(janalysis.Roofline)]
