"""One process per rank over torch.distributed
(qserve_tpu/parallel/distributed.py).

The JAX package serves multi-host REPLICATED: every host runs the same
deterministic scheduler on the same requests, so every host marshals the
same step inputs and no scheduler traffic crosses between hosts. A PyTorch
program is one process per rank (torchrun's idiom), and that design carries
over whole: each rank is one process that runs the whole engine over its
own shard of the weights and of the KV cache, and the collectives of the
model step (parallel/tp.py: an all_reduce after o and after down, an
all_gather of the logits) are the only traffic between ranks.

Backend rule, stated once (`choose_backend`): nccl when every rank has a
card of its own, else gloo. Gloo covers ranks on the CPU and ranks that
share one card (NCCL refuses two ranks on one device); its all_reduce and
all_gather take CUDA tensors and stage them through the host.

`spawn` starts ranks as torchrun would (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT in each child's environment) with the `spawn`
start method, and joins them with a deadline.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

from qserve_tpu_torch.logger import init_logger

logger = init_logger(__name__)

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_world_size() -> int:
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else (one host)
    the world size."""
    import torch.distributed as dist

    n = _env_int("LOCAL_WORLD_SIZE")
    if n is not None:
        return n
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multihost() -> bool:
    """More ranks in the world than on this host."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() > local_world_size()


def is_rank0() -> bool:
    """The rank that prints and writes results (every rank when not
    distributed)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device="cuda"):
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` when CUDA is
    asked for without an index, else the device as given."""
    import torch

    from qserve_tpu_torch.utils.utils import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count())
    return dev


def ranks_per_device(device) -> int:
    """How many of this host's ranks share `device` (1 on the CPU, whose
    memory is not sized from the card)."""
    import torch

    if torch.device(device).type != "cuda":
        return 1
    return max(1, -(-local_world_size() // torch.cuda.device_count()))


def choose_backend(device, n_local: int) -> str:
    """nccl when every local rank has a card of its own, else gloo (ranks
    that share a card, and the CPU)."""
    import torch

    if torch.device(device).type == "cuda" and n_local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    tp_size: int,
    dp_size: int = 1,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, Any, "torch.device"]:
    """Join the process group and build one TP group per DP replica (ranks
    [d * tp_size, (d + 1) * tp_size) serve replica d). Rank and world size
    come from torchrun's RANK / WORLD_SIZE (`spawn` sets them too), the
    rendezvous from `init_method`, else from MASTER_ADDR / MASTER_PORT; a
    collective that waits timeout_s raises. Returns (tp rank, TP group, this
    rank's device) and makes that group the one parallel/tp.py's
    collectives use."""
    import torch
    import torch.distributed as dist

    from qserve_tpu_torch.parallel import tp as tpmod

    rank, world_size = _env_int("RANK"), _env_int("WORLD_SIZE")
    if rank is None or world_size is None:
        raise RuntimeError(
            "init_distributed needs RANK and WORLD_SIZE: launch under torchrun "
            "or parallel.distributed.spawn")
    if world_size != tp_size * dp_size:
        raise ValueError(f"world size {world_size} != tp {tp_size} x dp {dp_size}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n_local = _env_int("LOCAL_WORLD_SIZE") or world_size
    if backend is None:
        backend = choose_backend(dev, n_local)
    if not dist.is_initialized():
        logger.info(
            "rank %d/%d on %s: backend %s (nccl when every rank has a card of its "
            "own, else gloo; %d local ranks)", rank, world_size, dev, backend, n_local)
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))
    groups = [dist.new_group(list(range(d * tp_size, (d + 1) * tp_size)))
              for d in range(dp_size)] if dp_size > 1 else [dist.group.WORLD]
    group = groups[rank // tp_size]
    tpmod.set_tp_group(group, backend)
    return rank % tp_size, group, dev


def shutdown() -> None:
    """Leave the process group (a no-op when not distributed)."""
    import torch.distributed as dist

    from qserve_tpu_torch.parallel import tp as tpmod

    if dist.is_initialized():
        dist.destroy_process_group()
    tpmod.set_tp_group(None, None)


def _rank_entry(fn, rank, world_size, port, results, args) -> None:
    """Child: torchrun's environment, fn(rank, world_size, *args), the
    result or the traceback into `results`, then leave the group."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        try:
            shutdown()
        except Exception:  # noqa: BLE001 - the group may be broken
            pass


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run fn(rank, world_size, *args) in world_size new processes (the
    `spawn` start method: a parent with a CUDA context must not fork) and
    return their results in rank order. fn must be importable by name and
    its results picklable. Raises when a rank fails or exits without a
    result, or when the deadline passes; kills every rank still running."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = find_free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, port, results, tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(got))} gave no result "
                    f"within {timeout_s:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # its result may still be in the pipe: one more look
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                            "and no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return [got[r] for r in range(world_size)]
