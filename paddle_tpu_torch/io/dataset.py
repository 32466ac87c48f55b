"""Dataset ingestion: file-to-step training without Python-loop feeding.

Parity: python/paddle/fluid/dataset.py (DatasetFactory:21,
InMemoryDataset:269, QueueDataset:613, FileInstantDataset:690,
BoxPSDataset:725) + the C++ DataFeed stack it drives
(paddle/fluid/framework/data_feed.cc); the port's own copy of
``paddle_tpu/io/dataset.py``. This is how the reference trains CTR-scale
models straight from file lists: `exe.train_from_dataset(program,
dataset)`.

- File parsing is native: csrc/dataset_feed.cc threads parse the
  MultiSlot text format (optionally through a UNIX `pipe_command`)
  into flat per-slot value+length columns, off the GIL, built with g++
  at first use by ``utils/native.py``. A pure-python parser backs it up
  where the toolchain is missing (host code, not a device kernel); each
  dataset records which one ran in ``parser`` ("native" or "python"),
  and ``NATIVE_BUILD_ERROR`` holds why a build failed.
- The reference's trainer_factory.py / device_worker.py thread army
  (N HogwildWorkers each running the op list against a feed queue) is
  not ported: `train_from_dataset` is a host loop handing static-shape
  batches to the Executor's step. Host threads still matter for
  PARSING — that is where thread_num goes.
- Raggedness (lod_level > 0 slots): the padded `(batch, max_len)` tensor
  feeds the slot's own var name, and the per-instance lengths feed
  `<name>_seq_len` when the program declares such a var (the
  framework-wide explicit-length convention; LoD offsets never ride
  inside tensors).
- Batches keep ONE static shape per dataset (sparse slots pad to the
  dataset-wide max for InMemoryDataset, power-of-2 buckets for the
  streaming QueueDataset); only the tail batch — which the reference
  also runs at its natural size — differs, and `drop_last` removes even
  that.
- A multi-process fleet's global_shuffle exchanges the loaded instances
  over the ``torch.distributed`` world (``all_gather_object``).
"""

import ctypes
import subprocess
import threading

import numpy as np

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset",
           "FileInstantDataset", "BoxPSDataset", "DataFeedDesc"]


def _world_size():
    import torch.distributed as dist
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1

_df_lib = None
_df_lock = threading.Lock()
NATIVE_BUILD_ERROR = None    # why csrc/dataset_feed.cc did not load


def _load_df_lib():
    """Build-and-dlopen csrc/dataset_feed.cc; None if unavailable."""
    global _df_lib, NATIVE_BUILD_ERROR
    with _df_lock:
        if _df_lib is not None:
            return _df_lib or None
        try:
            from ..utils.native import build_and_load
            lib = build_and_load("dataset_feed.cc")
        except Exception as e:
            NATIVE_BUILD_ERROR = f"{type(e).__name__}: {e}"
            _df_lib = False
            return None
        lib.df_create.restype = ctypes.c_void_p
        lib.df_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.df_add_slot.restype = ctypes.c_int
        lib.df_add_slot.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.df_parse_files.restype = ctypes.c_int64
        lib.df_parse_files.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.df_num_instances.restype = ctypes.c_int64
        lib.df_num_instances.argtypes = [ctypes.c_void_p]
        lib.df_slot_vals_count.restype = ctypes.c_int64
        lib.df_slot_vals_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.df_copy_slot.restype = ctypes.c_int
        lib.df_copy_slot.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.df_copy_ins_ids.restype = ctypes.c_int
        lib.df_copy_ins_ids.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.df_clear.argtypes = [ctypes.c_void_p]
        lib.df_last_error.restype = ctypes.c_char_p
        lib.df_last_error.argtypes = [ctypes.c_void_p]
        lib.df_destroy.argtypes = [ctypes.c_void_p]
        _df_lib = lib
        return lib


def _fnv1a(data):
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _parse_files_python(slots, files, pipe_command, parse_ins_id,
                        parse_content):
    """Pure-python fallback for the native parser (same format, same
    errors; reference: data_feed.cc ParseOneInstance)."""
    cols = [([], []) for _ in slots]        # (vals, lens) per slot
    ins_ids = []
    for path in files:
        if pipe_command and pipe_command != "cat":
            with open(path, "rb") as fin:
                proc = subprocess.run(["/bin/sh", "-c", pipe_command],
                                      stdin=fin, capture_output=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pipe command {pipe_command!r} failed rc="
                    f"{proc.returncode} for {path}: "
                    f"{proc.stderr.decode(errors='replace')[:200]}")
            lines = proc.stdout.decode().splitlines()
        else:
            with open(path) as fin:
                lines = fin.read().splitlines()
        for line in lines:
            toks = line.split()
            if not toks:
                continue
            pos = 0
            for flag, sink in ((parse_ins_id, ins_ids),
                               (parse_content, None)):
                if flag:
                    if toks[pos] != "1":
                        raise ValueError(f"bad tagged field in line: "
                                         f"{line[:120]!r}")
                    if sink is not None:
                        sink.append(_fnv1a(toks[pos + 1].encode()))
                    pos += 2
            for i, s in enumerate(slots):
                num = int(toks[pos])
                pos += 1
                if num <= 0:
                    raise ValueError(
                        f"slot '{s['name']}': the number of ids can not "
                        f"be zero, you need padding it in data generator")
                if pos + num > len(toks):
                    raise ValueError(
                        f"slot '{s['name']}': truncated values "
                        f"(declared {num}, line has {len(toks) - pos})")
                if s["type"] == "float":
                    conv = float
                else:
                    def conv(t):
                        # uint64 feasigns >= 2^63 wrap to int64, same as
                        # the native parser's static_cast<int64_t>
                        v = int(t)
                        return v - (1 << 64) if v >= (1 << 63) else v
                cols[i][0].extend(conv(t) for t in toks[pos:pos + num])
                cols[i][1].append(num)
                pos += num
    out = []
    for (vals, lens), s in zip(cols, slots):
        dt = np.float32 if s["type"] == "float" else np.int64
        out.append((np.asarray(vals, dt), np.asarray(lens, np.int32)))
    ids = (np.asarray(ins_ids, np.uint64) if parse_ins_id
           else np.zeros(0, np.uint64))
    return out, ids


def _parse_files_native(slots, files, pipe_command, parse_ins_id,
                        parse_content, n_threads):
    lib = _load_df_lib()
    ctx = lib.df_create(1 if parse_ins_id else 0, 1 if parse_content else 0)
    try:
        for s in slots:
            t = b"uint64" if s["type"] == "uint64" else b"float"
            lib.df_add_slot(ctx, s["name"].encode(), t, 1 if s["is_dense"]
                            else 0)
        blob = b"".join(f.encode() + b"\0" for f in files)
        n = lib.df_parse_files(ctx, blob, len(files),
                               (pipe_command or "").encode(),
                               max(1, n_threads))
        if n < 0:
            raise RuntimeError("dataset parse failed: "
                               + lib.df_last_error(ctx).decode())
        n_ins = lib.df_num_instances(ctx)
        out = []
        for i, s in enumerate(slots):
            nvals = lib.df_slot_vals_count(ctx, i)
            dt = np.float32 if s["type"] == "float" else np.int64
            vals = np.empty(nvals, dt)
            lens = np.empty(n_ins, np.int32)
            lib.df_copy_slot(ctx, i, vals.ctypes.data_as(ctypes.c_void_p),
                             lens.ctypes.data_as(
                                 ctypes.POINTER(ctypes.c_int32)))
            out.append((vals, lens))
        ids = np.zeros(0, np.uint64)
        if parse_ins_id:
            ids = np.empty(n_ins, np.uint64)
            lib.df_copy_ins_ids(ctx, ids.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint64)))
        return out, ids
    finally:
        lib.df_destroy(ctx)


def _parse_files(slots, files, pipe_command, parse_ins_id=False,
                 parse_content=False, n_threads=1):
    """-> (columns, ins_ids, parser): parser is "native" or "python"."""
    if _load_df_lib() is not None:
        return _parse_files_native(slots, files, pipe_command,
                                   parse_ins_id, parse_content,
                                   n_threads) + ("native",)
    return _parse_files_python(slots, files, pipe_command, parse_ins_id,
                               parse_content) + ("python",)


class DataFeedDesc:
    """Parity: python/paddle/fluid/data_feed_desc.py — a text-protobuf
    DataFeedDesc the user can tweak before handing to a dataset. Backed
    by a plain dict here (no protobuf runtime needed)."""

    def __init__(self, proto_desc_text):
        self._desc = _parse_text_desc(proto_desc_text)

    def set_batch_size(self, batch_size):
        self._desc["batch_size"] = int(batch_size)

    def set_dense_slots(self, dense_slots_name):
        for s in self._desc["slots"]:
            if s["name"] in dense_slots_name:
                s["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        for s in self._desc["slots"]:
            if s["name"] in use_slots_name:
                s["is_used"] = True

    def desc(self):
        return _format_text_desc(self._desc)


def _parse_text_desc(text):
    """Minimal text-format protobuf reader for DataFeedDesc messages."""
    desc = {"name": "MultiSlotDataFeed", "batch_size": 32,
            "pipe_command": "cat", "slots": []}
    stack = [desc]
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.endswith("{"):
            key = line[:-1].strip()
            if key == "slots":
                slot = {"name": "", "type": "float", "is_dense": False,
                        "is_used": False, "shape": []}
                desc["slots"].append(slot)
                stack.append(slot)
            else:                       # multi_slot_desc wrapper
                stack.append(stack[-1])
        elif line == "}":
            stack.pop()
        elif ":" in line:
            key, val = line.split(":", 1)
            key, val = key.strip(), val.strip()
            if val.startswith('"'):
                val = val.strip('"')
            elif val in ("true", "false"):
                val = val == "true"
            else:
                try:
                    val = int(val)
                except ValueError:
                    pass
            tgt = stack[-1]
            if key == "shape":
                tgt.setdefault("shape", []).append(val)
            elif key in ("name", "type", "is_dense", "is_used",
                         "batch_size", "pipe_command"):
                tgt[key] = val
    return desc


def _format_text_desc(desc):
    lines = [f'name: "{desc["name"]}"',
             f'batch_size: {desc["batch_size"]}',
             f'pipe_command: "{desc["pipe_command"]}"',
             "multi_slot_desc {"]
    for s in desc["slots"]:
        lines.append("  slots {")
        lines.append(f'    name: "{s["name"]}"')
        lines.append(f'    type: "{s["type"]}"')
        lines.append(f'    is_dense: {"true" if s["is_dense"] else "false"}')
        lines.append(f'    is_used: {"true" if s["is_used"] else "false"}')
        for d in s.get("shape", []):
            lines.append(f"    shape: {d}")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"


class DatasetFactory:
    """Parity: fluid.DatasetFactory (dataset.py:21)."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        try:
            return globals()[datafeed_class]()
        except KeyError:
            raise ValueError("datafeed class %s does not exist"
                             % datafeed_class)


class DatasetBase:
    """Parity: fluid.dataset.DatasetBase (dataset.py:63)."""

    _feed_name = "MultiSlotDataFeed"

    def __init__(self):
        self.pipe_command = "cat"
        self.batch_size = 32
        self.thread_num = 0
        self.filelist = []
        self.slots = []             # {name, type, is_dense, shape, lod_level}
        self.drop_last = False
        self._shuffle_seed = None   # set for deterministic shuffles
        self.parser = None          # "native" | "python": the last parse

    # -- knob setters (names + semantics from the reference) -----------
    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.slots = []
        for var in var_list:
            if var.dtype == "float32":
                t = "float"
            elif var.dtype == "int64":
                t = "uint64"
            else:
                raise ValueError(
                    "Currently, fluid.dataset only supports dtype=float32 "
                    "and dtype=int64")
            shape = [int(s) for s in var.shape if int(s) > 0]
            self.slots.append({
                "name": var.name, "type": t,
                "is_dense": var.lod_level == 0, "shape": shape,
                "is_used": True, "lod_level": var.lod_level,
            })

    def set_hdfs_config(self, fs_name, fs_ugi):
        # no HDFS client here; record for desc parity
        self.fs_name, self.fs_ugi = fs_name, fs_ugi

    def set_fea_eval(self, record_candidate_size, fea_eval=True):
        self.fea_eval = fea_eval
        self._record_candidate_size = record_candidate_size

    def slots_shuffle(self, slots):
        raise NotImplementedError(
            "slots_shuffle is only supported by InMemoryDataset")

    def set_shuffle_seed(self, seed):
        """Extension: deterministic shuffles (the reference seeds its
        shuffle from std::random_device)."""
        self._shuffle_seed = seed

    # ------------------------------------------------------------------
    def _prepare_to_run(self):
        if not self.slots:
            raise RuntimeError("dataset.set_use_var was never called")
        if self.thread_num > len(self.filelist):
            self.thread_num = len(self.filelist)
        if self.thread_num <= 0:
            self.thread_num = 1

    def _finish_to_run(self):
        pass

    def desc(self):
        return _format_text_desc({
            "name": self._feed_name, "batch_size": self.batch_size,
            "pipe_command": self.pipe_command, "slots": self.slots})

    # -- batch assembly shared by the subclasses -----------------------
    def _columns_to_batches(self, cols, order, pad_caps):
        """Yield feed dicts of `batch_size` instances following `order`.

        Dense slots gather to (B, *shape); sparse slots pad to the
        static cap and also emit `<name>_seq_len`. The tail keeps its
        natural size unless drop_last."""
        bs = self.batch_size
        n = len(order)
        starts = []
        for s, (vals, lens) in zip(self.slots, cols):
            if s["is_dense"] and len(lens):
                d = int(np.prod(s["shape"])) if s["shape"] else 1
                if not (lens == d).all():
                    bad = int(np.argmax(lens != d))
                    raise ValueError(
                        f"dense slot '{s['name']}' expects {d} values per "
                        f"instance (shape {s['shape']}), but instance "
                        f"{bad} has {int(lens[bad])}")
            off = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            starts.append(off)
        for b0 in range(0, n, bs):
            idx = order[b0:b0 + bs]
            if len(idx) < bs and self.drop_last:
                return
            feed = {}
            for s, (vals, lens), off in zip(self.slots, cols, starts):
                take_lens = lens[idx]
                if s["is_dense"]:
                    d = int(np.prod(s["shape"])) if s["shape"] else 1
                    # every instance holds d values (checked above): the
                    # rows of an (instances, d) view, gathered at once
                    gather = vals.reshape(-1, d)[idx]
                    feed[s["name"]] = gather.reshape(
                        (len(idx),) + tuple(s["shape"] or [1]))
                else:
                    cap = pad_caps[s["name"]]
                    padded = np.zeros((len(idx), cap), vals.dtype)
                    for r, i in enumerate(idx):
                        row = vals[off[i]:off[i + 1]]
                        padded[r, :len(row)] = row
                    feed[s["name"]] = padded
                    feed[s["name"] + "_seq_len"] = take_lens.reshape(-1, 1)
            yield feed


class InMemoryDataset(DatasetBase):
    """Parity: fluid.InMemoryDataset (dataset.py:269): load all files
    into host memory, shuffle (locally or across workers), train."""

    _feed_name = "MultiSlotInMemoryDataFeed"

    def __init__(self):
        super().__init__()
        self.queue_num = None
        self.parse_ins_id = False
        self.parse_content = False
        self.merge_by_lineid = False
        self.fleet_send_batch_size = None
        self._cols = None          # [(vals, lens)] per slot
        self._ins_ids = None
        self._order = None
        self._preload_thread = None

    # -- knob setters ---------------------------------------------------
    def set_queue_num(self, queue_num):
        self.queue_num = queue_num

    def set_parse_ins_id(self, parse_ins_id):
        self.parse_ins_id = parse_ins_id

    def set_parse_content(self, parse_content):
        self.parse_content = parse_content

    def set_fleet_send_batch_size(self, fleet_send_batch_size):
        self.fleet_send_batch_size = fleet_send_batch_size

    def set_merge_by_lineid(self, var_list=None, erase_duplicate_feas=True,
                            min_merge_size=2, keep_unmerged_ins=True):
        self._merge_slots = ([v.name for v in var_list]
                             if var_list else None)
        self._erase_duplicate = erase_duplicate_feas
        self._min_merge_size = min_merge_size
        self._keep_unmerged = keep_unmerged_ins
        self.merge_by_lineid = True
        self.parse_ins_id = True

    # -- loading --------------------------------------------------------
    def load_into_memory(self):
        self._prepare_to_run()
        self._cols, self._ins_ids, self.parser = _parse_files(
            self.slots, self.filelist, self.pipe_command,
            self.parse_ins_id, self.parse_content, self.thread_num)
        self._order = np.arange(len(self._cols[0][1]))

    def preload_into_memory(self):
        """Async load (reference: dataset.py:426)."""
        self._prepare_to_run()
        self._preload_thread = threading.Thread(target=self.load_into_memory,
                                                daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self):
        if self._preload_thread is not None:
            self._preload_thread.join()
            self._preload_thread = None

    def release_memory(self):
        self._cols = self._ins_ids = self._order = None

    # -- shuffles -------------------------------------------------------
    def local_shuffle(self):
        self._require_loaded()
        rng = np.random.default_rng(self._shuffle_seed)
        rng.shuffle(self._order)

    def global_shuffle(self, fleet=None):
        """Across-worker shuffle. The reference redistributes records
        over the fleet via pserver client2client messages; here:

        - multi-PROCESS fleet (a torch.distributed world of more than
          one process): all-gather the columns, then every process keeps
          its deterministic
          hash shard — instance -> worker by ins_id hash (keeps
          merge_by_lineid groups together) or by global index. Same
          result as the reference's redistribution (each record lands
          on exactly one worker, regardless of which worker loaded it)
          at the cost of a transient full copy per host.
        - single-process simulated fleets (worker_num > 1 from a role
          maker, one process): no channel
          exists, so every worker must have loaded the SAME filelist;
          the hash partition then selects this worker's shard.
        """
        self._require_loaded()
        nworker, wid = 1, 0
        if fleet is not None:
            fleet.barrier_worker()
            nworker, wid = fleet.worker_num(), fleet.worker_index()
        if nworker > 1:
            if _world_size() > 1:
                self._allgather_columns()
            if (self.parse_ins_id and self._ins_ids is not None
                    and len(self._ins_ids)):
                keys = self._ins_ids.astype(np.uint64)
            else:
                # splitmix64 over the global index: cheap, uniform
                keys = np.arange(len(self._order), dtype=np.uint64)
                keys = (keys + np.uint64(0x9E3779B97F4A7C15))
                keys ^= keys >> np.uint64(30)
                keys = keys * np.uint64(0xBF58476D1CE4E5B9)
                keys ^= keys >> np.uint64(27)
            mine = np.where(keys % np.uint64(nworker) == np.uint64(wid))[0]
            self._select_instances(mine)
        rng = np.random.default_rng(self._shuffle_seed)
        rng.shuffle(self._order)
        if self.merge_by_lineid:
            self._merge_by_lineid_now()
        if fleet is not None:
            fleet.barrier_worker()

    def _allgather_columns(self):
        """Exchange every process's loaded instances over the
        torch.distributed world so each host sees the union (in rank
        order) before hash-partitioning."""
        import torch.distributed as dist

        def gather(arr):
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, np.ascontiguousarray(arr))
            return np.concatenate(parts)

        # instance order must follow self._order so prior local state
        # (a local_shuffle before global_shuffle) is preserved per rank
        self._apply_order()
        self._cols = [(gather(vals), gather(lens))
                      for vals, lens in self._cols]
        if (self.parse_ins_id and self._ins_ids is not None
                and len(self._ins_ids)):
            self._ins_ids = gather(self._ins_ids)
        self._order = np.arange(len(self._cols[0][1]))

    def _apply_order(self):
        """Materialize self._order into the physical column layout."""
        if self._order is None or np.array_equal(
                self._order, np.arange(len(self._order))):
            return
        self._select_instances(self._order)

    def slots_shuffle(self, slots):
        """Shuffle the VALUES of the named slots across instances while
        other slots stay put (feature-importance debugging; reference:
        dataset.py:117 + fea_eval)."""
        self._require_loaded()
        rng = np.random.default_rng(self._shuffle_seed)
        names = {s["name"]: i for i, s in enumerate(self.slots)}
        for name in slots:
            i = names[name]
            vals, lens = self._cols[i]
            if not (lens == lens[0]).all():
                raise NotImplementedError(
                    "slots_shuffle over ragged slots is unsupported")
            w = int(lens[0])
            perm = rng.permutation(len(lens))
            self._cols[i] = (vals.reshape(-1, w)[perm].reshape(-1), lens)

    # -- sizes ----------------------------------------------------------
    def get_memory_data_size(self, fleet=None):
        self._require_loaded()
        return self._global_sum(len(self._order), fleet)

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    # -- internals ------------------------------------------------------
    def _require_loaded(self):
        if self._cols is None:
            raise RuntimeError("call load_into_memory() first")

    @staticmethod
    def _global_sum(local, fleet):
        if fleet is not None and _world_size() > 1:
            import torch.distributed as dist
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, int(local))
            return int(sum(parts))
        return local

    def _select_instances(self, keep_idx):
        """Physically keep only `keep_idx` instances (global_shuffle's
        partition step)."""
        new_cols = []
        for (vals, lens) in self._cols:
            off = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            parts = [vals[off[i]:off[i + 1]] for i in keep_idx]
            new_cols.append((np.concatenate(parts) if parts
                             else vals[:0], lens[keep_idx]))
        self._cols = new_cols
        if self._ins_ids is not None and len(self._ins_ids):
            self._ins_ids = self._ins_ids[keep_idx]
        self._order = np.arange(len(keep_idx))

    def _merge_by_lineid_now(self):
        """Merge instances sharing an ins_id (reference MergeByInsId:
        listed slots concatenate values — optionally deduped — other
        slots keep the first instance's values)."""
        ids = self._ins_ids
        if ids is None or not len(ids):
            return
        groups = {}
        for row in self._order:
            groups.setdefault(ids[row], []).append(row)
        merge_all = getattr(self, "_merge_slots", None) is None
        merged_cols = [([], []) for _ in self.slots]
        keep_rows = []
        offs = []
        for vals, lens in self._cols:
            off = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            offs.append(off)
        for gid, rows in groups.items():
            if len(rows) < self._min_merge_size:
                if self._keep_unmerged:
                    keep_rows.extend(rows)
                continue
            for i, s in enumerate(self.slots):
                vals, lens = self._cols[i]
                off = offs[i]
                # dense slots keep their fixed values-per-instance
                # contract: always take the first instance's values
                if not s["is_dense"] and (merge_all
                                          or s["name"] in
                                          self._merge_slots):
                    cat = np.concatenate([vals[off[r]:off[r + 1]]
                                          for r in rows])
                    if self._erase_duplicate:
                        _, first = np.unique(cat, return_index=True)
                        cat = cat[np.sort(first)]
                else:
                    r = rows[0]
                    cat = vals[off[r]:off[r + 1]]
                merged_cols[i][0].append(cat)
                merged_cols[i][1].append(len(cat))
        # rebuild: merged groups first, then kept singles (stable)
        final_cols = []
        for i, s in enumerate(self.slots):
            vals, lens = self._cols[i]
            off = offs[i]
            parts = list(merged_cols[i][0]) + [
                vals[off[r]:off[r + 1]] for r in keep_rows]
            plens = list(merged_cols[i][1]) + [int(lens[r])
                                               for r in keep_rows]
            final_cols.append((
                np.concatenate(parts) if parts else vals[:0],
                np.asarray(plens, np.int32)))
        self._cols = final_cols
        self._ins_ids = None
        self._order = np.arange(len(final_cols[0][1]))

    def _pad_caps(self):
        caps = {}
        for s, (vals, lens) in zip(self.slots, self._cols):
            if not s["is_dense"]:
                caps[s["name"]] = int(lens.max()) if len(lens) else 1
        return caps

    def _iter_batches(self, thread_num=None):
        self._require_loaded()
        yield from self._columns_to_batches(self._cols, self._order,
                                            self._pad_caps())


class QueueDataset(DatasetBase):
    """Parity: fluid.QueueDataset (dataset.py:613): stream files one at
    a time without loading the whole dataset; no shuffles."""

    _feed_name = "MultiSlotDataFeed"

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset does not support local shuffle, "
            "please use InMemoryDataset for local_shuffle")

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset does not support global shuffle, "
            "please use InMemoryDataset for global_shuffle")

    def _iter_batches(self, thread_num=None):
        """Stream batches file-by-file with a one-file lookahead parsed
        on a background thread (the native parser releases the GIL, so
        parse overlaps device steps). Instances cross file boundaries;
        sparse slots pad to a power-of-2 bucket to bound the shapes."""
        nt = thread_num or self.thread_num or 1

        def parse(f):
            cols, ids, self.parser = _parse_files(
                self.slots, [f], self.pipe_command, n_threads=nt)
            return cols, ids

        def start_lookahead(path):
            box = {}

            def work():
                try:
                    box["cols"] = parse(path)[0]
                except Exception as e:     # re-raised on the consumer side
                    box["err"] = e
            th = threading.Thread(target=work, daemon=True)
            th.start()
            return th, box

        pending = None
        carry = None
        for fi, path in enumerate(self.filelist):
            if pending is None:
                cols, _ = parse(path)
            else:
                th, box = pending
                th.join()
                if "err" in box:
                    raise box["err"]
                cols = box["cols"]
            pending = (start_lookahead(self.filelist[fi + 1])
                       if fi + 1 < len(self.filelist) else None)
            if carry is not None:
                cols = [(np.concatenate([cv, v]),
                         np.concatenate([cl, l]))
                        for (cv, cl), (v, l) in zip(carry, cols)]
                carry = None
            n = len(cols[0][1])
            full = (n // self.batch_size) * self.batch_size
            if full:
                order = np.arange(full)
                caps = {}
                for s, (vals, lens) in zip(self.slots, cols):
                    if not s["is_dense"]:
                        m = int(lens[:full].max())
                        caps[s["name"]] = max(1, 1 << (m - 1).bit_length())
                yield from self._columns_to_batches(cols, order, caps)
            if n > full:        # remainder rides into the next file
                keep = np.arange(full, n)
                carry = []
                for vals, lens in cols:
                    off = np.zeros(len(lens) + 1, np.int64)
                    np.cumsum(lens, out=off[1:])
                    carry.append((vals[off[full]:],
                                  lens[keep]))
        if carry is not None and not self.drop_last:
            n = len(carry[0][1])
            caps = {}
            for s, (vals, lens) in zip(self.slots, carry):
                if not s["is_dense"]:
                    m = int(lens.max()) if len(lens) else 1
                    caps[s["name"]] = max(1, 1 << (m - 1).bit_length())
            yield from self._columns_to_batches(carry, np.arange(n), caps)


class FileInstantDataset(QueueDataset):
    """Parity: fluid.FileInstantDataset (dataset.py:690) — streaming
    feed without the queue indirection; same streaming semantics here."""

    _feed_name = "MultiSlotFileInstantDataFeed"

    def local_shuffle(self):
        raise NotImplementedError(
            "FileInstantDataset does not support local shuffle, "
            "please use InMemoryDataset for local_shuffle")

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "FileInstantDataset does not support global shuffle, "
            "please use InMemoryDataset for global_shuffle")


class BoxPSDataset(InMemoryDataset):
    """Parity: fluid.BoxPSDataset (dataset.py:725). BoxPS is a GPU
    parameter-server cache; here the params live in the scope on the
    device, so begin/end_pass are pass-through markers."""

    _feed_name = "MultiSlotInMemoryDataFeed"

    def begin_pass(self):
        pass

    def end_pass(self):
        pass

    def load_into_memory(self):
        super().load_into_memory()

    def preload_into_memory(self):
        super().preload_into_memory()
