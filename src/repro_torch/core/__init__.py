"""The paper's contributions as composable features.

  * T1 — :mod:`repro_torch.core.softmax` (unified-max partial softmax and
          its combines, single-process and collective),
          :mod:`repro_torch.core.phi` (φ calibration and the per-arch
          registry) and :mod:`repro_torch.core.attention` (sequence-split
          decode attention over the mesh's ``model`` axis; imported on
          its own, as it reaches the kernels).
  * T2 — the flat GEMM, :mod:`repro_torch.kernels.flat_gemm`.
  * T3 — :mod:`repro_torch.core.dispatch` (cost models, decision flows,
          the card's GEMM timer) and :mod:`repro_torch.core.plan` (the
          tuned, serializable :class:`~repro_torch.core.plan.ExecutionPlan`
          every op dispatches by).
"""
from repro_torch.core import dispatch, phi, plan, softmax  # noqa: F401
