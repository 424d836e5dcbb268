"""Static analysis for the port (port of ``repro/analysis``): plan
verification (``analysis.verify``) against a step traced on meta tensors
(``analysis.trace``), and the layering lint (``analysis.lint``).

Every guarantee a plan claims -- wire bytes, wire dtypes, quant-block
alignment of ring chunks, the gathered-buffer peak, fused decodes, EF
threading -- is declared on the plan (``ShardingPlan.invariants``) and
proved here against the traced step, before a step runs on the card.
"""
from .trace import (BufferTrace, CollectiveEvent, CommTrace, Conversion,
                    LeafSpec, StepTrace, trace_plan,
                    trace_train_step)
from .verify import (VerificationError, VerificationReport, Violation,
                     verify_plan_static, verify_runtime, verify_trace)

__all__ = [
    "BufferTrace", "CollectiveEvent", "CommTrace", "Conversion", "LeafSpec",
    "StepTrace", "trace_plan", "trace_train_step", "VerificationError",
    "VerificationReport", "Violation", "verify_plan_static",
    "verify_runtime", "verify_trace",
]
