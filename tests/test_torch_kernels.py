"""The port's kernel twins against the JAX package's Pallas kernels (run in
interpret mode through repro.kernels.ops, as tests/test_kernels.py does),
on the same numpy inputs.  Quantize, permute+pad and the scaling-aware
transpose are bitwise (the transpose also against the reference's float
``transpose_direct``, subnormal edge included); the grouped GEMMs (NN,
transposed-weight and NT) are held to rtol=atol=2e-2 (f32 summation
order), the NN one also to the mean-relative-error check against the
dequantized product; the quant-out GEMM has equal scales and payload codes
within one on at most 0.1% of lanes (the f32 sums' order moves a value
across a rounding boundary); SwiGLU+quantize has equal scales and equal
payload bytes except on lanes where the f32 sigmoid bits of the two
libraries differ, and there at most one e4m3 code.

The launches of the hand-written CUDA kernels are held against the twins
on the card in tests/test_torch_gpu.py (no jax there)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fp8 import TILE
from repro.core.quant import QTensor as JQ
from repro.core.quant import _dequantize_nocount, quantize
from repro.core.transpose import transpose_direct as jtranspose_direct
from repro.kernels import ops as jops
from repro.kernels.fp8_transpose import _rebase_exponent as jrebase
from repro.kernels.fp8_transpose import fp8_transpose_pallas
from repro.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_pallas
from repro.kernels.grouped_gemm_nt_fp8 import grouped_gemm_nt_fp8_pallas
from repro_torch import kernels
from repro_torch.core.quant import QTensor
from repro_torch.core.transpose import transpose_direct
from repro_torch.kernels import ops
from repro_torch.kernels.fp8_transpose import (_rebase_exponent,
                                                fp8_transpose_plain)
from repro_torch.kernels.fused_permute_pad import fused_permute_pad_plain
from repro_torch.kernels.fused_swiglu_quant import fused_swiglu_quant_plain
from repro_torch.kernels.grouped_gemm_fp8 import grouped_gemm_fp8_plain
from repro_torch.kernels.grouped_gemm_nt_fp8 import grouped_gemm_nt_fp8_plain
from repro_torch.kernels.quantize import quantize_rowwise_plain


def _u8(a):
    return np.asarray(a).view(np.uint8)


def _t(a, dtype=None):
    """numpy / jax array -> torch tensor with the same bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _x(seed, *shape, spread=1.5):
    r = np.random.default_rng(seed)
    return (r.normal(size=shape) * np.exp(r.normal(size=shape) * spread)
            ).astype(np.float32)


def _q(x, tile):
    q = quantize(jnp.asarray(x), tile, tag="t")
    return q, QTensor(_t(q.data), _t(q.scale), tuple(q.tile))


def _ordinal(b):
    """e4m3 byte -> signed code index (sign-magnitude order)."""
    b = b.astype(np.int32)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


# ---------------------------------------------------------------------------
# CPU: plain twins vs the Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(40, 256), (128, 384), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_twin_matches_pallas(shape, dtype):
    xj = jnp.asarray(_x(1, *shape)).astype(dtype)
    qj = jops.quantize_rowwise(xj)
    d, s = quantize_rowwise_plain(_t(xj))
    assert np.array_equal(d.view(torch.uint8).numpy(), _u8(qj.data))
    assert np.array_equal(s.numpy(), np.asarray(qj.scale))


@pytest.mark.parametrize("t,d,n_out", [(32, 256, 48), (16, 128, 40),
                                       (24, 384, 8)])
def test_permute_pad_twin_matches_pallas(t, d, n_out):
    r = np.random.default_rng(12)
    x = jnp.asarray(r.normal(size=(t, d))).astype(jnp.float8_e4m3fn)
    x = x.at[0, 0].set(jnp.nan)                     # NaN payloads are data
    sc = jnp.asarray(np.exp2(r.integers(-8, 8, (t, d // TILE))
                             ).astype(np.float32))
    row_map = r.integers(-1, t, n_out).astype(np.int32)
    row_map[0] = 0
    qj = jops.fused_permute_pad(JQ(x, sc, (1, TILE)), jnp.asarray(row_map),
                                n_out)
    xo, so = fused_permute_pad_plain(_t(x), _t(sc), torch.from_numpy(row_map))
    assert np.array_equal(xo.view(torch.uint8).numpy(), _u8(qj.data))
    assert np.array_equal(so.numpy(), np.asarray(qj.scale))


@pytest.mark.parametrize("e,c,k,n", [(2, 128, 128, 128), (4, 8, 256, 128),
                                     (3, 40, 384, 256)])
def test_grouped_gemm_twin_matches_pallas(e, c, k, n):
    qxj, qx = _q(_x(5, e, c, k, spread=0.5), (1, 1, TILE))
    qwj, qw = _q(_x(6, e, k, n, spread=0.3) * 0.05, (1, TILE, TILE))
    out_j = np.asarray(jops.grouped_gemm_fp8(qxj, qwj), np.float32)
    out_t = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale)
    out_t = out_t.to(torch.float32).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=2e-2, atol=2e-2)
    gt = np.einsum("eck,ekn->ecn",
                   np.asarray(_dequantize_nocount(qxj, jnp.float32)),
                   np.asarray(_dequantize_nocount(qwj, jnp.float32)))
    rel = np.abs(out_t - gt) / (np.abs(gt) + 1e-2)
    assert rel.mean() < 2e-2


@pytest.mark.parametrize("m,f", [(128, 128), (40, 256), (8, 384)])
def test_swiglu_quant_twin_matches_pallas(m, f):
    h = jnp.asarray(_x(11, m, 2 * f, spread=0.5)).astype(jnp.bfloat16)
    qj = jops.fused_swiglu_quant(h)
    d, s = fused_swiglu_quant_plain(_t(h))
    assert np.array_equal(s.numpy(), np.asarray(qj.scale))
    # lanes whose f32 sigmoid bits differ between torch and jax
    g = np.array(h[:, :f].astype(jnp.float32))
    sig_j = np.asarray(jax.nn.sigmoid(jnp.asarray(g))).view(np.uint32)
    sig_t = torch.sigmoid(torch.from_numpy(g)).numpy().view(np.uint32)
    differ = sig_j != sig_t
    assert differ.mean() < 0.01
    bt, bj = d.view(torch.uint8).numpy(), _u8(qj.data)
    assert np.array_equal(bt[~differ], bj[~differ])
    assert np.abs(_ordinal(bt) - _ordinal(bj))[differ].max(initial=0) <= 1


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (128, 256),
                                   (384, 384)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp8_transpose_twin_matches_pallas_bitwise(shape, seed):
    qj = jops.quantize_rowwise(jnp.asarray(_x(seed, *shape, spread=2.5)))
    dj, sj = fp8_transpose_pallas(qj.data, qj.scale)
    d, s = fp8_transpose_plain(_t(qj.data), _t(qj.scale))
    assert np.array_equal(d.view(torch.uint8).numpy(), _u8(dj))
    assert np.array_equal(s.numpy(), np.asarray(sj))


def test_fp8_transpose_subnormal_edge_bitwise():
    """Rows 2**22 apart in one block: rebasing shifts deep into and past the
    subnormal range (tests/test_kernels.py's edge case)."""
    r = np.random.default_rng(3)
    x = r.normal(size=(128, 128)).astype(np.float32)
    x[::2] *= 2.0 ** 12
    x[1::2] *= 2.0 ** -10
    qj = jops.quantize_rowwise(jnp.asarray(x))
    dj, sj = fp8_transpose_pallas(qj.data, qj.scale)
    d, s = fp8_transpose_plain(_t(qj.data), _t(qj.scale))
    assert np.array_equal(d.view(torch.uint8).numpy(), _u8(dj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert (d.view(torch.uint8).numpy() & 0x78 == 0).any()   # subnormals


# every e4m3 encoding against every k a po2 scale pair can give (scales
# span 2**+-126): the integer rebase the CUDA kernel's word-wise fast paths
# and its table (csrc/fp8_transpose.cu) stand in for
_ENC = np.arange(256, dtype=np.int32)[None, :]
_K = np.arange(253, dtype=np.int32)[:, None]


def test_rebase_exponent_twin_matches_reference_bitwise():
    ref = np.asarray(jrebase(jnp.asarray(np.broadcast_to(_ENC, (253, 256))
                                         .astype(np.uint8)), jnp.asarray(_K)))
    twin = _rebase_exponent(torch.from_numpy(_ENC), torch.from_numpy(_K))
    assert np.array_equal(twin.numpy().astype(np.uint8), ref)


def test_rebase_exponent_saturates_to_sign_from_k19():
    """From k = 19 every encoding, NaN included, rebases to its sign bit;
    at k = 18 some do not (the kernel's k >= 19 path)."""
    twin = _rebase_exponent(torch.from_numpy(_ENC),
                            torch.from_numpy(_K)).numpy()
    assert np.array_equal(twin[19:], np.broadcast_to(_ENC & 0x80, (234, 256)))
    assert (twin[18] != (_ENC[0] & 0x80)).any()
    # exponent fields above k: one subtraction of k << 3 (the kernel's
    # word-wise path)
    for k in range(19):
        above = ((_ENC[0] >> 3) & 0xF) > k
        assert np.array_equal(twin[k][above], _ENC[0][above] - (k << 3))


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (128, 256),
                                   (384, 384), (2, 128, 256), (3, 256, 384)])
def test_transpose_direct_matches_reference_bitwise(shape):
    """The port's transpose_direct (through the kernel's twin) against the
    reference's float formulation, and zero ledger events."""
    qj, q = _q(_x(4, *shape, spread=2.5), (1,) * (len(shape) - 1) + (TILE,))
    rj = jtranspose_direct(qj)
    from repro_torch.core import casts
    with casts.ledger() as led:
        qt = transpose_direct(q)
    assert led.total() == 0
    assert qt.tile == tuple(rj.tile)
    assert np.array_equal(qt.data.view(torch.uint8).numpy(), _u8(rj.data))
    assert np.array_equal(qt.scale.numpy(), np.asarray(rj.scale))


@pytest.mark.parametrize("e,m,n,c", [(2, 128, 128, 128), (2, 256, 128, 256),
                                     (3, 128, 384, 384)])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_grouped_gemm_nt_twin_matches_pallas(e, m, n, c, out_dtype):
    qaj, qa = _q(_x(7, e, m, c, spread=0.5), (1, 1, TILE))
    qbj, qb = _q(_x(8, e, n, c, spread=0.5) * 0.05, (1, 1, TILE))
    oj = np.asarray(grouped_gemm_nt_fp8_pallas(
        qaj.data, qaj.scale, qbj.data, qbj.scale,
        out_dtype=jnp.dtype(out_dtype)), np.float32)
    ot = grouped_gemm_nt_fp8_plain(qa.data, qa.scale, qb.data, qb.scale,
                                   getattr(torch, out_dtype))
    np.testing.assert_allclose(ot.to(torch.float32).numpy(), oj, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("e,c,k,n", [(2, 128, 256, 128), (2, 256, 384, 256)])
@pytest.mark.parametrize("w_trans", [False, True])
def test_grouped_gemm_quant_out_twin_matches_pallas(e, c, k, n, w_trans):
    """The quant-out epilogue, reading w as stored or transposed, against
    grouped_gemm_fp8_pallas(quant_out=True) on the same (logical) w."""
    qxj, qx = _q(_x(9, e, c, k, spread=0.5), (1, 1, TILE))
    stored = (e, n, k) if w_trans else (e, k, n)
    qwj, qw = _q(_x(10, *stored, spread=0.3) * 0.05, (1, TILE, TILE))
    wj, swj = qwj.data, qwj.scale
    if w_trans:
        wj, swj = jnp.swapaxes(wj, 1, 2), jnp.swapaxes(swj, 1, 2)
    dj, sj = grouped_gemm_fp8_pallas(qxj.data, qxj.scale, wj, swj,
                                     quant_out=True)
    d, s = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                  w_trans=w_trans, quant_out=True)
    assert np.array_equal(s.numpy(), np.asarray(sj))
    diff = np.abs(_ordinal(d.view(torch.uint8).numpy()) - _ordinal(_u8(dj)))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("e,c,k,n", [(2, 128, 256, 128), (3, 40, 384, 256)])
def test_grouped_gemm_transposed_weight_twin(e, c, k, n):
    """Reading a stored (E, N, K) weight transposed equals the product with
    its materialized transpose bit for bit, and the Pallas kernel within
    rtol=atol=2e-2; ops routes a transposed view there."""
    _, qx = _q(_x(11, e, c, k, spread=0.5), (1, 1, TILE))
    qwj, qw = _q(_x(12, e, n, k, spread=0.3) * 0.05, (1, TILE, TILE))
    out = grouped_gemm_fp8_plain(qx.data, qx.scale, qw.data, qw.scale,
                                 w_trans=True)
    wt = qw.data.transpose(1, 2).contiguous()
    swt = qw.scale.transpose(1, 2).contiguous()
    assert torch.equal(out, grouped_gemm_fp8_plain(qx.data, qx.scale, wt,
                                                   swt))
    view = QTensor(qw.data.transpose(1, 2), qw.scale.transpose(1, 2),
                   qw.tile)
    assert torch.equal(out, ops.grouped_gemm_fp8(qx, view))
    qxj = JQ(jnp.asarray(np.asarray(qx.data.view(torch.uint8)).view(
        jnp.float8_e4m3fn)), jnp.asarray(qx.scale.numpy()), (1, 1, TILE))
    oj = jops.grouped_gemm_fp8(qxj, JQ(jnp.swapaxes(qwj.data, 1, 2),
                                       jnp.swapaxes(qwj.scale, 1, 2),
                                       (1, TILE, TILE)))
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(oj, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_cpu_route_launches_no_kernel():
    """On CPU tensors the wrappers take the twins: no launch is counted."""
    before = dict(kernels.LAUNCHES)
    qx = ops.quantize_rowwise(torch.randn(8, 256))
    ops.fused_permute_pad(qx, torch.tensor([1, -1, 0], dtype=torch.int32))
    ops.fused_swiglu_quant(torch.randn(8, 256).to(torch.bfloat16))
    qw = QTensor(qx.data[:, :128].reshape(1, 8, 128).repeat(1, 16, 1),
                 torch.ones(1, 1, 1), (1, TILE, TILE))
    q3 = QTensor(qx.data.reshape(1, 8, 256)[:, :, :128].contiguous(),
                 qx.scale.reshape(1, 8, 2)[:, :, :1].contiguous(), (1, 1, TILE))
    ops.grouped_gemm_fp8(q3, qw)
    ops.grouped_gemm_fp8_quant_out(q3, qw)
    q128 = QTensor(qw.data, torch.ones(1, 128, 1), (1, 1, TILE))
    ops.grouped_gemm_nt_fp8(q128, q128)
    ops.fp8_transpose(q128)
    assert kernels.LAUNCHES == before
