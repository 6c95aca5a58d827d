"""The evaluation harness of the port (port of ``i2pnet_tpu/eval``). The
projection overlays (``eval/visualize.py``, PIL and imageio) are not ported
yet."""

from i2pnet_tpu_torch.eval.analysis import parse_prediction_file, recall_analysis
from i2pnet_tpu_torch.eval.evaluator import SECTION, Evaluator

__all__ = ["SECTION", "Evaluator", "parse_prediction_file", "recall_analysis"]
