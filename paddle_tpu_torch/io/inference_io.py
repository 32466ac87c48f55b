"""save/load_inference_model.

Parity: fluid.io.save_inference_model / load_inference_model
(python/paddle/fluid/io.py); the port's own copy of
``paddle_tpu/io/inference_io.py``, writing the same directory. The
program is serialized as JSON (the ProgramDesc format of
core/framework.py's ``to_json``, the JAX package's own) + params as npz,
so a model saved by either package loads in the other. The loaded
parameters land on the executor's device.
"""

import json
import os

from ..core.framework import Program, Variable
from .state import save_params, load_params


MODEL_FILENAME = "__model__.json"
PARAMS_FILENAME = "__params__.npz"


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    from ..core.framework import default_main_program
    program = (main_program or default_main_program()).clone(for_test=True)
    program._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": json.loads(program.to_json()),
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name if isinstance(v, Variable) else v
                        for v in target_vars],
    }
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME), "w") as f:
        json.dump(meta, f)
    save_params(executor, dirname, program,
                filename=params_filename or PARAMS_FILENAME)
    return meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = Program.from_json(json.dumps(meta["program"]))
    load_params(executor, dirname, program,
                filename=params_filename or PARAMS_FILENAME)
    gb = program.global_block()
    fetch_vars = [gb.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
