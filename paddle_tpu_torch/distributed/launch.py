"""Multi-process training launcher.

Parity: python/paddle/distributed/launch.py (start_procs:132,
launch:243); the counterpart of ``paddle_tpu/distributed/launch.py``.
Starts one training process a local rank with the PaddleCloud
environment (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
PADDLE_TRAINER_ENDPOINTS / PADDLE_CURRENT_ENDPOINT); in the script,
``fleet.init()`` reads it and joins the ``torch.distributed`` world (the
first endpoint is the rendezvous), then builds fleet's mesh.

Usage (as the reference's):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \
        --selected_gpus=0,0 --log_dir=logs train.py --arg1 ...

Several nodes: give every node the same --cluster_node_ips (a comma list)
and its own --node_ip; ranks are node_id * nproc_per_node + local_i.

Devices: --selected_gpus lists the cards, and local rank i takes entry
i % len (PADDLE_SELECTED_DEVICES); PADDLE_NODE_DEVICES lists every local
rank's entry, so each rank sees the node's layout. A device listed more
than once is shared: ``--selected_gpus=0,0`` runs two ranks on one card,
where ``fleet.init`` takes gloo (one card cannot hold two NCCL ranks);
distinct cards take NCCL.

The ranks stay in the launcher's process group: killing the group of a
launcher started in its own session stops every rank. The launcher
itself stops the others at the first non-zero exit and raises.
"""

import argparse
import os
import signal
import subprocess
import sys
import time
from argparse import REMAINDER


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch multi-process launcher "
                    "(parity: paddle.distributed.launch)")
    parser.add_argument(
        "--cluster_node_ips", type=str, default="127.0.0.1",
        help="comma-separated IPs of all nodes")
    parser.add_argument("--node_ip", type=str, default="127.0.0.1",
                        help="this node's IP")
    parser.add_argument(
        "--use_paddlecloud", action="store_true",
        help="pick node identity up from the PaddleCloud env "
             "(PADDLE_TRAINERS / POD_IP / PADDLE_TRAINER_ID)")
    parser.add_argument("--started_port", type=int, default=6170,
                        help="first rendezvous port on each node")
    parser.add_argument("--print_config", type=bool, default=True)
    parser.add_argument(
        "--nproc_per_node", type=int, default=None,
        help="processes per node (default: len(--selected_gpus) or 1)")
    parser.add_argument(
        "--selected_gpus", "--selected_devices", dest="selected_gpus",
        type=str, default=None,
        help="the cards, one entry a local rank (repeats share a card); "
             "exported per process as PADDLE_SELECTED_DEVICES")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="write per-process workerlog.N files here")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=REMAINDER)
    return parser.parse_args(argv)


def _stop(procs, grace=10.0):
    """SIGTERM every live rank, then SIGKILL what outlives `grace`."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def start_procs(args):
    """Start the local worker processes and wait; raises
    CalledProcessError at the first non-zero exit, after stopping the
    others (reference launch.py:132)."""
    node_ips = [x.strip() for x in args.cluster_node_ips.split(",")]
    current_node_ip = args.node_ip
    node_id = node_ips.index(current_node_ip)
    if args.use_paddlecloud:
        # reference launch.py:143: PaddleCloud publishes identity via env
        trainer_nums = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        if trainer_nums != 1:
            current_node_ip = os.environ["POD_IP"]
            node_ips = os.environ["PADDLE_TRAINERS"].split(",")
            node_id = int(os.environ["PADDLE_TRAINER_ID"])

    selected = ([x.strip() for x in args.selected_gpus.split(",")]
                if args.selected_gpus else None)
    nproc = args.nproc_per_node or (len(selected) if selected else 1)
    if selected and nproc > len(selected):
        raise ValueError(
            f"--nproc_per_node={nproc} exceeds the {len(selected)} "
            f"entries of --selected_gpus (one entry a rank; list a card "
            f"twice to share it)")
    num_nodes = len(node_ips)
    nranks = num_nodes * nproc

    endpoints = ",".join(f"{ip}:{args.started_port + i}"
                         for ip in node_ips for i in range(nproc))
    if args.print_config:
        print(f"trainers_endpoints: {endpoints} , node_id: {node_id} , "
              f"current_node_ip: {current_node_ip} , num_nodes: "
              f"{num_nodes} , nranks: {nranks}", flush=True)

    # plain dicts: copy.copy(os.environ) aliases the live environment
    base_env = dict(os.environ)
    # proxies break the rendezvous sockets (the reference drops them too)
    base_env.pop("http_proxy", None)
    base_env.pop("https_proxy", None)
    node_devices = [selected[i % len(selected)] for i in range(nproc)] \
        if selected else None

    procs, cmds, log_fns = [], [], []
    try:
        for i in range(nproc):
            env = dict(base_env)
            env.update({
                "PADDLE_TRAINER_ID": str(node_id * nproc + i),
                "PADDLE_CURRENT_ENDPOINT":
                    f"{current_node_ip}:{args.started_port + i}",
                "PADDLE_TRAINERS_NUM": str(nranks),
                "PADDLE_TRAINER_ENDPOINTS": endpoints,
                "PADDLE_LOCAL_RANK": str(i),
                "PADDLE_NPROC_PER_NODE": str(nproc),
            })
            if node_devices:
                env["PADDLE_SELECTED_DEVICES"] = node_devices[i]
                env["PADDLE_NODE_DEVICES"] = ",".join(node_devices)
            cmd = [sys.executable, "-u", args.training_script] \
                + args.training_script_args
            cmds.append(cmd)
            out = None
            if args.log_dir:
                os.makedirs(args.log_dir, exist_ok=True)
                out = open(os.path.join(args.log_dir, f"workerlog.{i}"), "w")
                log_fns.append(out)
            procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                          stderr=out))

        # poll every rank: one dead rank leaves its peers blocked in a
        # collective, so at the first failure stop the survivors instead
        # of waiting on them in index order
        first_fail = None
        while first_fail is None and any(p.poll() is None for p in procs):
            for i, p in enumerate(procs):
                if p.poll() is not None and p.returncode != 0:
                    first_fail = (i, p.returncode)
                    break
            else:
                time.sleep(0.2)
        if first_fail is None:
            first_fail = next(((i, p.returncode) for i, p in enumerate(procs)
                               if p.returncode != 0), None)
    finally:
        _stop(procs)
        for fn in log_fns:
            fn.close()
    if first_fail:
        i, rc = first_fail
        raise subprocess.CalledProcessError(returncode=rc, cmd=cmds[i])


def launch(argv=None):
    args = _parse_args(argv)
    # a SIGTERM to the launcher stops its ranks too (finally above)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    start_procs(args)


if __name__ == "__main__":
    launch()
