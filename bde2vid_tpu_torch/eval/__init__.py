"""Evaluation: checkpoints, the sequence driver, result tables and the CLI
(counterpart of ``bde2vid_tpu/eval``)."""

from bde2vid_tpu_torch.eval.driver import EvalConfig, evaluate_all, evaluate_sequence
from bde2vid_tpu_torch.eval.tables import generate_table

__all__ = ["evaluate_sequence", "evaluate_all", "EvalConfig", "generate_table"]
