"""repro_torch.core — Shifted Randomized SVD (Basirat 2019) in PyTorch.

Public API of this slice:
  srsvd / rsvd            single-device (Algorithm 1 / Halko baseline)
  FixedRangeFinder / WarmStartRangeFinder / warm_omega
                          the basis-building phase
  PCA                     implicit-centering principal component analysis
  qr_rank1_update         Golub & Van Loan rank-1 thin-QR update
  as_linop / DenseOp / LinOp   operator protocol over X
  ContactEngine / get_engine / register_backend   unified contact layer
  ShiftSchedule / FixedShift / DecayingShift / DynamicShift
  StopRule / FixedIters / PVEStop / ResidualStop / ConvergenceReport
"""
from repro_torch.core.contact import (ContactEngine, available_backends,
                                      default_backend, get_engine,
                                      register_backend)
from repro_torch.core.linop import DenseOp, LinOp, as_linop
from repro_torch.core.pca import PCA
from repro_torch.core.qr_update import qr_rank1_update
from repro_torch.core.rangefinder import (FixedRangeFinder, GrowthState,
                                          WarmStartRangeFinder, warm_omega)
from repro_torch.core.schedule import (DecayingShift, DynamicShift,
                                       FixedShift, ShiftSchedule,
                                       as_schedule)
from repro_torch.core.srsvd import (SVDResult, expected_error_bound, rsvd,
                                    srsvd)
from repro_torch.core.stopping import (ConvergenceReport, FixedIters,
                                       PVEStop, ResidualStop, StopRule,
                                       as_rule)

__all__ = [
    "ContactEngine", "available_backends", "default_backend",
    "get_engine", "register_backend",
    "DenseOp", "LinOp", "as_linop", "PCA", "qr_rank1_update",
    "FixedRangeFinder", "GrowthState", "WarmStartRangeFinder",
    "warm_omega",
    "DecayingShift", "DynamicShift", "FixedShift", "ShiftSchedule",
    "as_schedule", "SVDResult", "expected_error_bound", "rsvd", "srsvd",
    "ConvergenceReport", "FixedIters", "PVEStop", "ResidualStop",
    "StopRule", "as_rule",
]
