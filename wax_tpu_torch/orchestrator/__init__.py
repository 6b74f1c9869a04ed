"""Memory orchestrator: the primary public API (reference:
Sources/Wax/Orchestrator/MemoryOrchestrator.swift:6)."""
from wax_tpu_torch.orchestrator.config import OrchestratorConfig, RewriteSchedule
from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator, RememberResult

__all__ = ["MemoryOrchestrator", "OrchestratorConfig", "RememberResult", "RewriteSchedule"]
