"""Inference helpers of the port (the dense-cache decode loops and the
host detection postprocess of paddle_tpu/inference/)."""
