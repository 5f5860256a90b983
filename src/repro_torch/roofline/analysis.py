"""Roofline analysis of a step on one H100, from counts of what it runs.

Counterpart of ``repro.roofline.analysis``.  Three terms, each in seconds
a step on an H100 SXM:

  compute    = FLOPs / peak bf16 FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / NVLink bandwidth (one direction)

The reference reads FLOPs and "bytes accessed" from XLA's
``compiled.cost_analysis()`` and collective bytes from the compiled HLO
text.  The port runs eagerly and has neither, so it counts what a step
executes while it runs, inside ``tally()``:

- every aten op is seen by a ``TorchDispatchMode``: its FLOPs by the
  formulas of ``torch.utils.flop_counter`` (matmuls, convolutions,
  attention; 0 for the others), its bytes as the ``nbytes`` of its input
  and output tensors (an in-place op's tensor counts as read and written;
  views and allocations move nothing).  The mode is in the thread-local
  state autograd carries into its backward threads, so the backward (and a
  checkpoint block's recompute) is counted with the forward;
- the hand-written kernels launch through ``ctypes`` and never reach the
  dispatcher, so each wrapper in ``kernels/ops.py`` reports its kernel's
  FLOPs and bytes by formula (the bytes and operations of ``chip_smoke.py``'s
  bounds; a masked kernel its live 128-row tiles, counted on the device
  and read when the tally is read) and the aten ops inside the wrapper are
  not counted: on the CPU those are the twin's, which stands in for the
  kernel.  So the CPU and the GPU tally of one step report the same
  kernels; the aten ops around them can still differ where the port takes
  a device's own route (the segment sum, the CPU's f32 bf16-products).

The collective term counts what the collective wrappers of
``dist/comm.py`` hand to ``torch.distributed`` (the dispatch and combine
messages of the EP blocks, the TP stages' token gathers, combine
all-reduces or reduce-scatters and input-gradient all-reduces, the FSDP
weight gathers and their gradients' reduce-scatters, the DP wire's bucket
messages and amax agreement, the ZeRO-1 gather, the plain step's
gradient all-reduce): each call records its kind and buffer bytes in the
open tally.  ``coll_bytes``
is what one rank of a modelled world of ``n_chips`` ranks puts on the
interconnect for those buffers, the ring factors of
``dist/comm.wire_factor`` (all-to-all, all-gather and reduce-scatter
(n-1)/n, all-reduce 2(n-1)/n), the model ``dist/grad_comm.wire_grad_bytes`` uses; on one card
(n_chips = 1) that is 0 whatever the buffers, which
``Tally.coll_buffer_bytes`` still reports.  ``collective_bytes(hlo_text)``
is not ported: its input is HLO text.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# H100 SXM constants (NVIDIA data sheet): dense tensor-core FLOP/s, the f32
# non-tensor rate, HBM3 bytes/s, NVLink 4 bytes/s in one direction
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP8 = 1979e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
# NVLink 4 on the H100 SXM: 900 GB/s bidirectional over 18 links (NVIDIA
# H100 data sheet), 450 GB/s in one direction
NVLINK_BW = 450e9
# the bound of a kernel row (chip_smoke.py): bytes/s and each input type's
# peak
PEAKS = dict(bw=HBM_BW, fp8=PEAK_FLOPS_FP8, bf16=PEAK_FLOPS_BF16,
             f32=PEAK_FLOPS_F32)

# the kernels whose FLOPs are grouped-GEMM products
GEMM_KERNELS = ("grouped_gemm_fp8", "grouped_gemm_fp8_quant_out",
                "grouped_gemm_nt_fp8", "masked_grouped_gemm_fp8",
                "masked_grouped_gemm_fp8_quant_out",
                "masked_grouped_gemm_nt_fp8",
                "masked_grouped_gemm_swiglu_quant")

_aten = torch.ops.aten
# ops that move no bytes: allocations (views are told by their schema)
_NO_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten.detach,
             _aten.lift_fresh, _aten._local_scalar_dense}

_NULL = contextlib.nullcontext()
_ACTIVE = None                    # the open Tally, seen by every thread


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class Tally:
    """FLOPs and bytes of the work run inside ``tally()``: aten ops by op,
    hand-written kernels by name."""

    def __init__(self):
        self.aten = {}                 # op -> [flops, bytes, calls]
        self._kernels = {}             # name -> [flops list, bytes list]
        self.coll = {}                 # collective kind -> [calls, bytes]
        self._depth = 0

    # -- recording --------------------------------------------------------
    def _op(self, func, args, kwargs, out):
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = 0
        if packet not in _NO_BYTES and not func.is_view:
            nbytes = _nbytes(tree_leaves((args, kwargs))) + \
                _nbytes(tree_leaves(out))
        rec = self.aten.setdefault(str(packet), [0, 0, 0])
        rec[0] += flops
        rec[1] += nbytes
        rec[2] += 1

    @contextlib.contextmanager
    def _kernel(self, name, counts):
        outer = self._depth == 0
        self._depth += 1
        try:
            if outer:
                flops, nbytes = counts()
                rec = self._kernels.setdefault(name, [[], []])
                rec[0].append(flops)
                rec[1].append(nbytes)
            yield
        finally:
            self._depth -= 1

    def _collective(self, kind, nbytes):
        rec = self.coll.setdefault(kind, [0, 0])
        rec[0] += 1
        rec[1] += nbytes

    # -- reading (one host read for the counts kept on the device) ---------
    @staticmethod
    def _total(values) -> float:
        host = sum(float(v) for v in values if not torch.is_tensor(v))
        dev = [v for v in values if torch.is_tensor(v)]
        if dev:
            host += float(torch.stack([v.to(torch.float64).cpu()
                                       for v in dev]).sum())
        return host

    def kernels(self) -> Dict[str, dict]:
        """{kernel: {flops, bytes, launches}}."""
        return {k: dict(flops=self._total(f), bytes=self._total(b),
                        launches=len(f))
                for k, (f, b) in self._kernels.items()}

    def kernel_flops_each(self, name: str):
        """Each launch's FLOPs of kernel `name`, in launch order."""
        return [self._total([v]) for v in self._kernels.get(name, [[]])[0]]

    @property
    def aten_flops(self) -> float:
        return float(sum(r[0] for r in self.aten.values()))

    @property
    def aten_bytes(self) -> float:
        return float(sum(r[1] for r in self.aten.values()))

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(k["flops"]
                                     for k in self.kernels().values())

    @property
    def hbm_bytes(self) -> float:
        return self.aten_bytes + sum(k["bytes"]
                                     for k in self.kernels().values())

    @property
    def coll_buffer_bytes(self) -> float:
        """Bytes of the buffers handed to collectives (every kind)."""
        return float(sum(r[1] for r in self.coll.values()))

    def coll_bytes(self, n_chips: int) -> float:
        """Bytes one rank of an n_chips world sends for those buffers."""
        from repro_torch.dist.comm import wire_factor
        return float(sum(wire_factor(k, n_chips) * r[1]
                         for k, r in self.coll.items()))

    @property
    def gemm_flops(self) -> float:
        """The grouped-GEMM kernels' FLOPs and aten's (matmuls)."""
        ks = self.kernels()
        return self.aten_flops + sum(ks[k]["flops"] for k in GEMM_KERNELS
                                     if k in ks)


class _Mode(TorchDispatchMode):
    def __init__(self, t: Tally):
        super().__init__()
        self.t = t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.t._depth == 0:
            self.t._op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def tally():
    """Count the FLOPs and bytes of everything run inside (forward and
    backward).  Yields the Tally; read it after the block."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("roofline.tally() is already open")
    t = Tally()
    _ACTIVE = t
    try:
        with _Mode(t):
            yield t
    finally:
        _ACTIVE = None


def collective(kind: str, nbytes: int) -> None:
    """What a collective wrapper (``dist/comm.py``) calls: with a tally
    open, the call's kind and buffer bytes are recorded."""
    t = _ACTIVE
    if t is not None:
        t._collective(kind, nbytes)


def kernel(name: str, counts):
    """What a kernel wrapper opens around its body: with a tally open, the
    kernel's (FLOPs, bytes) from ``counts()`` are recorded and the aten ops
    inside are not; else a null context (one global read)."""
    t = _ACTIVE
    return _NULL if t is None else t._kernel(name, counts)


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip FLOPs
    hbm_bytes: float             # per-chip bytes accessed
    coll_bytes: float            # per-chip collective payload bytes
    coll_by_kind: Dict[str, int]
    model_flops: float           # 6*N*D useful flops (per chip)
    n_chips: int

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self):
        """No-overlap model: the dominant term bounds the step."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self):
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self):
        """Model-flops utilization at the no-overlap step time."""
        if self.step_time == 0:
            return 0.0
        return self.model_flops / PEAK_FLOPS_BF16 / self.step_time

    def to_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops, "n_chips": self.n_chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
            "step_time": self.step_time, "mfu": self.mfu,
            "useful_fraction": self.useful_fraction,
        }


def analyze_tally(t: Tally, *, model_flops_global: float,
                  n_chips: int = 1) -> Roofline:
    """The reference's ``analyze`` on a tally's counts; the collective
    term at a world of n_chips ranks (0 at one)."""
    return Roofline(flops=t.flops, hbm_bytes=t.hbm_bytes,
                    coll_bytes=t.coll_bytes(n_chips),
                    coll_by_kind={k: r[1] for k, r in t.coll.items()},
                    model_flops=model_flops_global / n_chips,
                    n_chips=n_chips)


def measured_mfu(model_flops: float, seconds: float) -> float:
    """Model FLOPs over the bf16 peak times a measured step time."""
    return model_flops / (PEAK_FLOPS_BF16 * seconds)


def model_flops_train(cfg, tokens: int) -> float:
    """6*N_active*D (the standard 'useful' training flops)."""
    return 6.0 * cfg.active_params() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_params() * tokens
