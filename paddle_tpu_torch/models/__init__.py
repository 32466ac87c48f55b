"""Models of the port (the params-dict layout of paddle_tpu/models/)."""
