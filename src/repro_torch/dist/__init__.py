"""The FP8-split optimizer state (``dist.opt_state``).

Counterpart of ``repro.dist``'s single-device part: the ``StatePolicy``
encodings that ``AdamWConfig(state_policy=StatePolicy())`` selects.  The
FP8 DP gradient wire, the ZeRO-1 flat buckets (``init_dist_state``,
``flat_bucket_update``) and ``DistPlan`` come with multi-GPU training
(ROADMAP.md, Queue 1, item 7).
"""
from repro_torch.dist.opt_state import StatePolicy  # noqa: F401
