"""The training runtime's fault handling: deterministic fault injection
(``fault_injection``) and the host-health and elastic bookkeeping
(``fault_tolerance``)."""
