"""Multi-process launch utilities.

Parity: python/paddle/distributed/ (launch.py, launch_ps.py); the
counterpart of ``paddle_tpu/distributed/``. The launcher sets the
PaddleCloud environment that ``parallel.fleet.PaddleCloudRoleMaker`` /
``fleet.init`` read, which joins the ``torch.distributed`` world (the
first endpoint is the rendezvous) with the backend the layout asks for.
"""


def __getattr__(name):
    # lazy: `python -m paddle_tpu_torch.distributed.launch` executes the
    # module anew, and an eager import here would make runpy warn that it
    # found it in sys.modules
    if name in ("launch", "launch_ps", "downpour"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
