"""HDFS shell-out client.

Parity: python/paddle/fluid/incubate/fleet/utils/hdfs.py and
contrib/utils/hdfs_utils.py:35 (HDFSClient), :437 (multi_download), :518
(multi_upload); the port's own copy of ``paddle_tpu/contrib/utils/
hdfs_utils.py``, which needs no device. Every method shells out to
``{hadoop_home}/bin/hadoop fs`` with the -D configs, retrying on a
non-zero exit. Deliberate differences from the reference: commands run
without ``shell=True`` (argv lists), and multi_download / multi_upload
use a thread pool instead of ``multiprocessing`` (the work is
subprocess-bound).
"""

import logging
import os
from concurrent.futures import ThreadPoolExecutor
import subprocess

__all__ = ["HDFSClient", "multi_download", "multi_upload"]

_logger = logging.getLogger(__name__)


class HDFSClient:
    """Thin wrapper over the ``hadoop fs`` CLI (ref hdfs_utils.py:35-58:
    same constructor contract — hadoop_home + dict of -D configs)."""

    def __init__(self, hadoop_home, configs=None):
        self.pre_commands = [os.path.join(hadoop_home, "bin", "hadoop"),
                             "fs"]
        for k, v in (configs or {}).items():
            self.pre_commands.append(f"-D{k}={v}")

    def _run(self, commands, retry_times=5):
        argv = self.pre_commands + list(commands)
        _logger.info("Running system command: %s", " ".join(argv))
        ret, out, err = 1, "", ""
        for attempt in range(retry_times + 1):
            proc = subprocess.run(argv, capture_output=True, text=True)
            ret, out, err = proc.returncode, proc.stdout, proc.stderr
            if ret == 0:
                break
            _logger.warning("Times: %d, Error running command: %s. "
                            "Return code: %d, Error: %s",
                            attempt, " ".join(argv), ret, err)
        return ret, out, err

    def upload(self, hdfs_path, local_path, overwrite=False, retry_times=5):
        """local file/dir -> hdfs (ref :95). Returns True on success."""
        cmd = ["-put", "-f"] if overwrite else ["-put"]
        ret, _, _ = self._run(cmd + [local_path, hdfs_path], retry_times)
        return ret == 0

    def download(self, hdfs_path, local_path, overwrite=False, unzip=False):
        """hdfs -> local (ref :145). Returns True on success."""
        if overwrite and os.path.exists(local_path):
            ret, _, _ = self._run(["-get", "-f", hdfs_path, local_path])
        else:
            ret, _, _ = self._run(["-get", hdfs_path, local_path])
        return ret == 0

    def is_exist(self, hdfs_path=None):
        ret, _, _ = self._run(["-test", "-e", hdfs_path], retry_times=1)
        return ret == 0

    def is_dir(self, hdfs_path=None):
        ret, _, _ = self._run(["-test", "-d", hdfs_path], retry_times=1)
        return ret == 0

    def delete(self, hdfs_path):
        """ref :243 — recursive delete, True if gone (or never existed)."""
        if not self.is_exist(hdfs_path):
            return True
        flag = "-rmr" if self.is_dir(hdfs_path) else "-rm"
        ret, _, _ = self._run([flag, hdfs_path])
        return ret == 0

    def rename(self, hdfs_src_path, hdfs_dst_path, overwrite=False):
        if overwrite and self.is_exist(hdfs_dst_path):
            self.delete(hdfs_dst_path)
        ret, _, _ = self._run(["-mv", hdfs_src_path, hdfs_dst_path])
        return ret == 0

    @staticmethod
    def make_local_dirs(local_path):
        os.makedirs(local_path, exist_ok=True)

    def makedirs(self, hdfs_path):
        if self.is_exist(hdfs_path):
            return True
        ret, _, _ = self._run(["-mkdir", "-p", hdfs_path])
        return ret == 0

    def ls(self, hdfs_path):
        """Immediate children paths (ref :353)."""
        if not self.is_exist(hdfs_path):
            return []
        ret, out, _ = self._run(["-ls", hdfs_path])
        if ret != 0:
            return []
        paths = []
        for line in out.splitlines():
            cols = line.split()
            if len(cols) >= 8 and not line.startswith("Found"):
                paths.append(cols[7])
        return paths

    def lsr(self, hdfs_path, only_file=True, sort=True):
        """Recursive listing; files only by default, mtime-sorted
        (ref :387)."""
        if not self.is_exist(hdfs_path):
            return []
        ret, out, _ = self._run(["-lsr", hdfs_path])
        if ret != 0:
            return []
        entries = []
        for line in out.splitlines():
            cols = line.split()
            if len(cols) < 8:
                continue
            if only_file and cols[0].startswith("d"):
                continue
            entries.append((cols[5] + " " + cols[6], cols[7]))
        if sort:
            entries.sort()
        return [p for _, p in entries]


def _shard(datas, trainer_id, trainers):
    return [d for i, d in enumerate(datas) if i % trainers == trainer_id]


def multi_download(client, hdfs_path, local_path, trainer_id, trainers,
                   multi_processes=5):
    """Download this trainer's shard of the files under hdfs_path using
    a pool of workers (ref :437-505; every trainers-th file belongs to
    this trainer). Returns the local file list."""
    assert isinstance(client, HDFSClient)
    client.make_local_dirs(local_path)
    all_files = client.lsr(hdfs_path, sort=True)
    my_files = _shard(all_files, trainer_id, trainers)
    _logger.info("Trainer %d needs %d files of %d", trainer_id,
                 len(my_files), len(all_files))

    def _one(data):
        re_path = os.path.relpath(os.path.dirname(data), hdfs_path)
        dst = (local_path if re_path == os.curdir
               else os.path.join(local_path, re_path))
        client.make_local_dirs(dst)
        client.download(data, dst)

    with ThreadPoolExecutor(max_workers=max(1, multi_processes)) as pool:
        list(pool.map(_one, my_files))

    local_files = []
    for dirpath, _, fnames in os.walk(local_path):
        for f in fnames:
            local_files.append(os.path.join(dirpath, f))
    return local_files


def multi_upload(client, hdfs_path, local_path, multi_processes=5,
                 overwrite=False, sync=True):
    """Upload everything under local_path with a pool of workers
    (ref :518-566)."""
    assert isinstance(client, HDFSClient)
    all_files = []
    for dirpath, _, fnames in os.walk(local_path):
        for f in fnames:
            all_files.append(os.path.join(dirpath, f))

    def _one(local_file):
        re_path = os.path.relpath(os.path.dirname(local_file), local_path)
        dst = (hdfs_path if re_path == os.curdir
               else os.path.join(hdfs_path, re_path))
        client.makedirs(dst)
        client.upload(dst, local_file, overwrite=overwrite)

    with ThreadPoolExecutor(max_workers=max(1, multi_processes)) as pool:
        list(pool.map(_one, all_files))
