"""Host-side helpers of the port: building the native libraries
(``native.py``) and the model statistics (``model_stat.py``)."""
