"""The evaluation harness of the port (port of ``i2pnet_tpu/eval``); the
projection overlays are ``eval/visualize.py``."""

from i2pnet_tpu_torch.eval.analysis import parse_prediction_file, recall_analysis
from i2pnet_tpu_torch.eval.evaluator import SECTION, Evaluator

__all__ = ["SECTION", "Evaluator", "parse_prediction_file", "recall_analysis"]
