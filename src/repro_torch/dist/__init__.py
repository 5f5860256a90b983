"""The FP8-split optimizer state (``dist.opt_state``) and the int8 scale
exponent codecs (``dist.scale_sync``).

Counterpart of ``repro.dist``'s single-device part: the ``StatePolicy``
encodings that ``AdamWConfig(state_policy=StatePolicy())`` selects, and
the exponent codecs the KV-page migration wire uses.  The
FP8 DP gradient wire, the ZeRO-1 flat buckets (``init_dist_state``,
``flat_bucket_update``) and ``DistPlan`` come with multi-GPU training
(ROADMAP.md, Queue 1, item 7).
"""
from repro_torch.dist.opt_state import StatePolicy  # noqa: F401
