"""Evaluators: grounding accuracy."""

from eda_tpu_torch.eval.grounding import GroundingEvaluator  # noqa: F401
