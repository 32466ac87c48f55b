"""Inference helpers of the port (the dense-cache decode loops of
paddle_tpu/inference/)."""
