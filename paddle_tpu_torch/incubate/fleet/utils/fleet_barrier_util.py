"""Parity: incubate/fleet/utils/fleet_barrier_util.py:20
(``check_all_trainers_ready``): an HDFS-file barrier for fleets whose
processes share only a filesystem.

As the reference: each trainer drops ``ready.{epoch}.{id}.done`` under
ready_path and polls until the file count is a multiple of worker_num.
Inside one job prefer ``fleet.barrier_worker()`` (a ``dist.barrier``, no
filesystem); this serves coordination across jobs (data-ready gating).
"""

import os
import time

from ....parallel.fleet import fleet
from .hdfs import HDFSClient

__all__ = ["check_all_trainers_ready"]


def check_all_trainers_ready(ready_path, epoch, poll_seconds=10):
    trainer_num = fleet.worker_num()
    trainer_id = fleet.worker_index()

    client = HDFSClient(os.getenv("HADOOP_HOME", ""), {
        "fs.default.name": os.getenv("FS_NAME", ""),
        "hadoop.job.ugi": os.getenv("FS_UGI", ""),
    })

    node_ready = f"ready.{epoch}.{trainer_id}.done"
    with open(node_ready, "w"):
        pass
    if not client.is_dir(ready_path):
        client.makedirs(ready_path)
    client.upload(ready_path, node_ready, overwrite=True, retry_times=0)

    while True:
        ready_num = len(client.ls(ready_path))
        if ready_num % trainer_num == 0:
            break
        time.sleep(poll_seconds)
