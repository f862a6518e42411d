"""Evaluators: grounding accuracy, detection AP, NMS."""

from eda_tpu_torch.eval.grounding import GroundingEvaluator  # noqa: F401
