"""Device meshes of the port, and the launcher of tensor-parallel ranks.

The JAX package has one controller over a ``("data", "model")`` grid of
devices.  The port runs the grid SPMD, the PyTorch way: one process per
rank of the ``"model"`` axis, joined by a ``torch.distributed`` process
group over that axis.  The ``"data"`` axis needs no collective (its router
is host scheduling), so every rank process hosts all ``data`` shards: shard
``i`` of rank ``r`` runs on ``mesh.devices[i, r]``.  On one card every cell
of the grid is the same device: data shards are separate engines with
private pools on it, model ranks are processes on it.

``make_production_mesh`` (256 TPU chips) is not ported (ROADMAP queue 1,
item 16).
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Mesh:
    """A ``(data, model)`` grid of ``torch.device``s, the model axis's
    process group and this process's rank in it (``None`` and 0 when the
    model axis is 1)."""

    axis_names: Tuple[str, str] = ("data", "model")

    def __init__(self, devices: np.ndarray, group=None):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (data, model) grid, got shape "
                             f"{devices.shape}")
        self.devices = devices
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def device(self, row: int = 0) -> torch.device:
        """The device of data shard ``row`` in this rank's column."""
        return self.devices[row, self.rank]


def _local_devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_host_mesh(model: int = 1, data: int = 0, *,
                   devices: Optional[Sequence] = None,
                   group=None) -> Mesh:
    """(data, model) mesh over ``devices`` (default: every visible card,
    else the CPU).  ``data=0`` means "all remaining devices"
    (``len(devices) // model``).  Validates the shape up front with the JAX
    function's rules.  One card holds any grid when ``devices`` repeats it
    (``[cuda:0] * n``).  ``group`` is the model axis's process group, of
    ``model`` ranks (default: the initialised default group); a model axis
    of 1 takes none."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else _local_devices())]
    n = len(devs)
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if model > n:
        raise ValueError(
            f"model={model} exceeds the {n} available device(s); on one "
            f"card pass devices=[cuda:0] * <N>")
    if data == 0:
        data = n // model
    if data < 1:
        raise ValueError(f"data axis size must be >= 1, got {data}")
    if data * model > n:
        raise ValueError(
            f"mesh ({data}, {model}) needs {data * model} devices but only "
            f"{n} are available")
    if group is None and model > 1:
        if not dist.is_initialized():
            raise ValueError(
                f"model={model} needs a process group of {model} ranks: "
                "initialise torch.distributed first (spawn_tp, torchrun)")
        group = dist.group.WORLD
    if group is not None and dist.get_world_size(group) != model:
        raise ValueError(f"the process group has "
                         f"{dist.get_world_size(group)} ranks, the model "
                         f"axis {model}")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devs[:data * model]):
        grid[i // model, i % model] = d
    return Mesh(grid, group if model > 1 else None)


def parse_mesh_shape(spec: str) -> Tuple[int, int]:
    """Parse a ``"dp2,tp4"`` mesh-shape string into ``(data, model)``.

    Parts may appear in either order and either may be omitted (defaults
    to 1): ``"tp2"`` → (1, 2), ``"dp4"`` → (4, 1).
    """
    dp, tp = 1, 1
    for part in spec.replace("x", ",").split(","):
        part = part.strip().lower()
        if not part:
            continue
        if part.startswith("dp"):
            dp = int(part[2:])
        elif part.startswith("tp"):
            tp = int(part[2:])
        else:
            raise ValueError(
                f"bad mesh shape {spec!r}: parts must look like dp<N>/tp<N>")
    if dp < 1 or tp < 1:
        raise ValueError(f"bad mesh shape {spec!r}: sizes must be >= 1")
    return dp, tp


# ---------------------------------------------------------------------------
# tensor-parallel ranks
# ---------------------------------------------------------------------------

def _rank_main(fn: Callable, rank: int, world: int, store_path: str,
               backend: str, timeout_s: float, args: tuple, results) -> None:
    """One rank: join the group, run ``fn(rank, *args)``, report
    ``(rank, True, result)`` or ``(rank, False, traceback)``."""
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:          # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_tp(fn: Callable, tp: int, *args: Any, backend: str,
             timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``tp`` rank processes joined by a
    ``backend`` process group; returns the ranks' results in rank order.

    The ranks start with the spawn method (the caller may have initialised
    CUDA already) and meet through a ``FileStore`` in a fresh temporary
    directory, so concurrent worlds never clash on a port.  Every rank gets
    the same ``PYTHONHASHSEED`` (the caller's, else 0), so iteration over
    sets of strings cannot differ between ranks, one CPU thread, and
    ``timeout_s`` on its collectives.  ``fn`` and its results must pickle.
    A rank that raises, dies, or outlives ``timeout_s`` plus half a minute
    of start-up fails the world: the others are killed and this raises."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spawn_tp-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, tp, os.path.join(tmp, "store"),
                               backend, timeout_s, args, results),
                         daemon=True)
             for r in range(tp)]
    env = {"PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED", "0")}
    if backend == "gloo":
        # the ranks share this host: gloo's transport binds the loopback
        env["GLOO_SOCKET_IFNAME"] = os.environ.get("GLOO_SOCKET_IFNAME",
                                                   "lo")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout_s + 30.0
    got: Dict[int, Any] = {}
    try:
        while len(got) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_tp: ranks {sorted(set(range(tp)) - set(got))} "
                    f"did not finish within {timeout_s:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_tp: rank(s) died without a "
                                       f"result (rank, exit code): {dead}")
                continue
            if not ok:
                raise RuntimeError(f"spawn_tp: rank {rank} failed:\n"
                                   f"{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(got) == tp else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(tp)]
