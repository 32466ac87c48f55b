"""Inference of the port (the counterpart of ``paddle_tpu/inference``).

Parity: paddle/fluid/inference (AnalysisPredictor). A saved model is
served by ``create_predictor(AnalysisConfig(dir))`` (predictor.py: the
Executor's inference walk on the card, batch buckets, bf16, int8,
tensor parallelism, and ``generation_server`` for GPT-family exports),
exported once per batch size by ``save_aot_model`` and served without a
Program by ``load_aot_model`` (aot.py: ``torch.export``), and batched
across client threads by ``serving.BatchingServer`` (serving.py, over
``csrc/serve_queue.cc``). The dense-cache decode loops live in
decoding.py (with the paged adapter's branch), the host detection
postprocess in postprocess.py.
"""

from .predictor import Predictor, create_predictor, AnalysisConfig
from .aot import save_aot_model, load_aot_model, AotModel
from .decoding import greedy_decode, beam_decode
from .postprocess import multiclass_nms_host

__all__ = ["Predictor", "create_predictor", "AnalysisConfig",
           "greedy_decode", "beam_decode", "multiclass_nms_host"]
