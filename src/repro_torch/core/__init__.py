"""T3 — the GEMM routing ladder (:mod:`repro_torch.core.dispatch`) and the
:class:`~repro_torch.core.plan.ExecutionPlan` every op dispatches by."""
