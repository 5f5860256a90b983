"""FP8-native distributed training state and wire.

Counterpart of ``repro.dist``: the FP8-split optimizer state
(``opt_state``: ``StatePolicy``, the ZeRO-1 flat shards), the DP wire's
plan (``plan``: ``DistPlan``, the bucket layout), the wire itself
(``grad_comm``: e4m3 payload + po2 int8 exponents in one uint8 message a
bucket), the scale agreement and exponent codecs (``scale_sync``), and
the counted collectives every multi-rank path runs through (``comm``).
"""
from repro_torch.dist.opt_state import StatePolicy  # noqa: F401
from repro_torch.dist.plan import (DistPlan, GradLayout,  # noqa: F401
                                   build_layout, streaming_fallback_reason)
