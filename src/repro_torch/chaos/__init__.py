"""Deterministic chaos campaigns for the fault-tolerant serving stack.

``python -m repro_torch.chaos --smoke`` is the CI entry point; see
:mod:`repro_torch.chaos.campaign` for the invariants a campaign asserts and
:mod:`repro_torch.chaos.shrink` for minimal-repro reduction of a failing
schedule.
"""

from .campaign import (CampaignReport, CaseResult, ChaosCase, ChaosHarness,
                       generate_campaign, run_campaign)
from .shrink import ddmin, shrink_case

__all__ = ["CampaignReport", "CaseResult", "ChaosCase", "ChaosHarness",
           "generate_campaign", "run_campaign", "ddmin", "shrink_case"]
